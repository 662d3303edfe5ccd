"""Checkpoint save/restore of a model's parameters.

Counterpart of ``deepards_tpu/train/checkpoint.py``: ``torch.save`` of the
params, and the same ``<path>.scaling.json`` sidecar with the training
fold's (mu, std) so inference can normalize inputs without the dataset.
``restore`` also reads an ``.npz`` of the JAX package's flat params (keys
"a/b/c", as ``flax.traverse_util.flatten_dict(params, sep="/")`` gives),
transplanted into the port's layout.
"""
import json
import os

import numpy as np
import torch

from deepards_tpu_torch.transplant import transplant


def save(path, params, scaling=None):
    """Write ``{"params": state_dict}`` to ``path`` (and the scaling
    sidecar when ``scaling`` is given)."""
    path = os.path.abspath(path)
    params = {k: v.detach().cpu() for k, v in params.items()}
    torch.save({"params": params}, path)
    if scaling is not None:
        mu, std = scaling
        with open(path + ".scaling.json", "w") as f:
            json.dump({
                "mu": np.asarray(mu, np.float64).ravel().tolist(),
                "std": np.asarray(std, np.float64).ravel().tolist(),
            }, f)
    return path


def restore(path):
    """``{"params": state_dict}`` on the CPU."""
    path = os.path.abspath(path)
    if path.endswith(".npz"):
        with np.load(path, allow_pickle=False) as z:
            return {"params": transplant({k: z[k] for k in z.files})}
    return torch.load(path, map_location="cpu", weights_only=True)


def load_scaling(path):
    """Scaling sidecar saved next to a checkpoint (None if absent)."""
    p = os.path.abspath(path) + ".scaling.json"
    if not os.path.exists(p):
        return None
    with open(p) as f:
        d = json.load(f)
    return (np.asarray(d["mu"], np.float32),
            np.asarray(d["std"], np.float32))
