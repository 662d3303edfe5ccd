"""PNG figures: drawn with matplotlib on the CPU host, refused by name
elsewhere.

The card's machine has no matplotlib, and a run on the card draws
nothing: each PNG stage prints its refusal, while the data behind the
figure is computed on the device and saved beside it (an ``.npz``) by
the caller.  matplotlib is imported inside the functions that draw.
"""
import os

import torch


def pyplot():
    """``matplotlib.pyplot`` on the non-interactive Agg backend."""
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    return plt


def refusal(device):
    """Why no PNG is drawn for a run on ``device`` here, or None."""
    if torch.device(device).type != "cpu":
        return "drawn on the CPU host only"
    try:
        import matplotlib  # noqa: F401
    except ImportError:
        return "matplotlib is missing"
    return None


def draw_or_refuse(stages, device):
    """Draw each (path, draw) stage (``draw(path)`` writes the PNG and
    returns its path) on the CPU host where matplotlib is present; else
    refuse each by name.  Returns the PNGs drawn."""
    reason = refusal(device)
    drawn = []
    for path, draw in stages:
        if reason:
            print("PNG stage {} refused: {}".format(
                os.path.basename(path), reason))
        else:
            drawn.append(draw(path))
            print(path)
    return drawn
