"""Checkpoint save/restore: params, optimizer state, generator, step.

Counterpart of ``deepards_tpu/train/checkpoint.py``: one ``torch.save``
file of ``{"params", "opt_state", "rng", "step"}`` (all but the params
optional), with the same sidecars as the JAX package: ``.scaling.json``
(the training fold's (mu, std), so inference normalizes inputs without the
dataset), ``.conf.json`` (the run's configuration) and ``.resume.json``
(resume bookkeeping: fold, epoch, next batch and, for a step checkpoint,
the epoch's order; the host generator's state).  ``restore`` also reads
an ``.npz`` of the JAX package's flat params (keys "a/b/c", as
``flax.traverse_util.flatten_dict(params, sep="/")`` gives), transplanted
into the port's layout.
"""
import json
import os

import numpy as np
import torch

from deepards_tpu_torch.transplant import transplant


def save(path, params, scaling=None, opt_state=None, rng=None, step=None,
         conf=None, resume_meta=None):
    """Write ``{"params": state_dict, ...}`` to ``path`` and its sidecars.

    ``opt_state`` is an optimizer's ``state_dict()``, ``rng`` a generator's
    ``get_state()``, ``conf`` a mapping (JSON-serialisable values kept)."""
    path = os.path.abspath(path)
    payload = {"params": {k: v.detach().cpu() for k, v in params.items()}}
    if opt_state is not None:
        payload["opt_state"] = _to_cpu(opt_state)
    if rng is not None:
        payload["rng"] = rng.cpu()
    if step is not None:
        payload["step"] = int(step)
    torch.save(payload, path)
    if scaling is not None:
        mu, std = scaling
        with open(path + ".scaling.json", "w") as f:
            json.dump({
                "mu": np.asarray(mu, np.float64).ravel().tolist(),
                "std": np.asarray(std, np.float64).ravel().tolist(),
            }, f)
    if resume_meta is not None:
        # a step checkpoint's epoch order is an index array
        meta = dict(resume_meta)
        if meta.get("perm") is not None:
            meta["perm"] = np.asarray(meta["perm"]).tolist()
        with open(path + ".resume.json", "w") as f:
            json.dump(meta, f)
    if conf is not None:
        with open(path + ".conf.json", "w") as f:
            json.dump({
                k: v for k, v in dict(conf).items()
                if isinstance(v, (str, int, float, bool, list, type(None)))
            }, f, indent=2)
    return path


def _to_cpu(tree):
    if isinstance(tree, torch.Tensor):
        return tree.detach().cpu()
    if isinstance(tree, dict):
        return {k: _to_cpu(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_to_cpu(v) for v in tree)
    return tree


def restore(path):
    """``{"params": state_dict[, "opt_state", "rng", "step"]}`` on the
    CPU."""
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


def load_resume_meta(path):
    """Resume metadata saved next to a checkpoint (None if absent)."""
    meta_path = os.path.abspath(path) + ".resume.json"
    if not os.path.exists(meta_path):
        return None
    with open(meta_path) as f:
        meta = json.load(f)
    if meta.get("perm") is not None:
        meta["perm"] = np.asarray(meta["perm"], np.int64)
    return meta
