"""PyTorch/CUDA port of deepards_tpu for one NVIDIA H100.

The port keeps the JAX package's module layout so each module has an
obvious counterpart, and imports nothing of it: ``deepards_tpu`` stays the
reference the port is tested against.  Entry points run on the card
(``device="cuda"``) unless the caller asks for the CPU, and raise when no
card is present.
"""
