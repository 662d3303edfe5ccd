"""Device resolution for the port's entry points."""
import torch


def resolve_device(device=None):
    """``device`` as a ``torch.device``; ``None`` means the card.

    Raises when CUDA is asked for (explicitly or by default) and no card
    is present: the port never falls back to the CPU on its own.
    """
    device = torch.device("cuda" if device is None else device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "CUDA device requested but torch.cuda.is_available() is False; "
            "pass device='cpu' to run on the CPU"
        )
    return device
