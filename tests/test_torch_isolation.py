"""The port stands alone: it imports no JAX and nothing of deepards_tpu,
and its entry points run on the card unless asked for the CPU."""
import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

_IMPORT_ALL = r"""
import json, pkgutil, sys
for blocked in ("jax", "jaxlib", "flax", "optax", "orbax"):
    sys.modules[blocked] = None  # any import of them raises ImportError
import deepards_tpu_torch
modules = ["deepards_tpu_torch"]
for info in pkgutil.walk_packages(deepards_tpu_torch.__path__,
                                  "deepards_tpu_torch."):
    __import__(info.name)
    modules.append(info.name)
import chip_smoke
loaded = sorted(k for k, v in sys.modules.items() if v is not None)
print(json.dumps({"modules": modules, "loaded": loaded}))
"""


def test_port_imports_no_jax_and_no_reference_package():
    out = subprocess.run(
        [sys.executable, "-c", _IMPORT_ALL], cwd=ROOT, env={
            **os.environ, "PYTHONPATH": ROOT},
        capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    report = json.loads(out.stdout.strip().splitlines()[-1])
    assert {"deepards_tpu_torch.cli.serve", "deepards_tpu_torch.ops.dtw",
            "deepards_tpu_torch.dtw.lib",
            "deepards_tpu_torch.transplant"} <= set(report["modules"])
    forbidden = [
        name for name in report["loaded"]
        if name == "deepards_tpu" or name.startswith("deepards_tpu.")
        or name.split(".")[0] in ("jax", "jaxlib", "flax", "optax", "orbax",
                                  "pandas", "yaml")
    ]
    assert forbidden == []


def test_entry_points_raise_without_cuda(tmp_path):
    """With no card, the default device is refused, never replaced."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    from deepards_tpu_torch.cli.serve import InferenceEngine
    from deepards_tpu_torch.dtw.lib import (
        batched_dtw_pairs,
        per_breath_dtw_scores,
    )
    from deepards_tpu_torch.ops.dtw import dtw_batch

    a = np.zeros((2, 8), np.float32)
    with pytest.raises(RuntimeError, match="CUDA"):
        InferenceEngine(str(tmp_path / "missing.pt"))
    with pytest.raises(RuntimeError, match="CUDA"):
        dtw_batch(a, a)
    with pytest.raises(RuntimeError, match="CUDA"):
        batched_dtw_pairs(list(a), list(a))
    with pytest.raises(RuntimeError, match="CUDA"):
        per_breath_dtw_scores(list(np.zeros((5, 8), np.float32)))


def test_dtw_cuda_refuses_cpu_tensors():
    """The kernel's wrapper has no CPU fallback: CPU tensors raise."""
    from deepards_tpu_torch.ops.dtw import dtw_cuda

    a = torch.zeros(2, 8)
    n = torch.full((2,), 8, dtype=torch.int32)
    with pytest.raises(ValueError, match="CUDA tensor"):
        dtw_cuda(a, a, n, n)


def test_resolve_device():
    from deepards_tpu_torch.device import resolve_device

    assert resolve_device("cpu") == torch.device("cpu")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError):
            resolve_device(None)
