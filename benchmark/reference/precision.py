"""Rounding to a lower precision, for the controls of the check.

Applied where the reference's operations produce their outputs, in the
program's place:

- ``fp8_e4m3`` rounds a tensor to float8 e4m3 under a scale that maps its
  largest magnitude to the format's largest finite value (448), as an fp8
  training step scales each tensor: the precision below the measured
  configuration's bfloat16, the control that has to fail the check;
- ``bf16`` rounds to bfloat16 without a scale: the configuration's own
  precision, a witness that a gap is the rounding's.

Both pass the gradient through unchanged.
"""
import torch

E4M3_MAX = 448.0


def fp8_e4m3(x):
    if not x.is_floating_point():
        return x
    value = x.detach()
    amax = value.abs().amax().clamp(min=1e-30)
    scale = E4M3_MAX / amax
    rounded = (value * scale).to(torch.float8_e4m3fn).to(x.dtype) / scale
    return x + (rounded - value)


def bf16(x):
    if not x.is_floating_point():
        return x
    value = x.detach()
    return x + (value.to(torch.bfloat16).to(x.dtype) - value)
