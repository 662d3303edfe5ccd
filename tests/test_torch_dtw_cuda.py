"""The CUDA DTW kernel on the card, against its plain PyTorch version.

The kernel has no CPU mode, so these tests carry the ``cuda`` marker and
skip without a card.  The file imports no JAX, so it runs on a machine
with the card but without JAX:

    python -m pytest tests/test_torch_dtw_cuda.py -m cuda --noconftest -q
"""
import numpy as np
import pytest
import torch

from deepards_tpu_torch.ops import dtw


def _pairs(seed, bsz, n, lo):
    rng = np.random.default_rng(seed)
    a = rng.normal(size=(bsz, n)).astype(np.float32)
    b = rng.normal(size=(bsz, n)).astype(np.float32)
    la = rng.integers(lo, n + 1, size=bsz).astype(np.int32)
    lb = rng.integers(lo, n + 1, size=bsz).astype(np.int32)
    a[np.arange(n)[None, :] >= la[:, None]] = 0
    b[np.arange(n)[None, :] >= lb[:, None]] = 0
    return a, b, la, lb


@pytest.mark.cuda
@pytest.mark.parametrize("bsz,n,lo", [(300, 97, 1), (512, 256, 150),
                                      (16, 1000, 1)])
def test_dtw_cuda_equals_reference_on_card(bsz, n, lo):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernel has no CPU mode)")
    dev = torch.device("cuda")
    a, b, la, lb = (torch.from_numpy(x).to(dev)
                    for x in _pairs(14, bsz, n, lo))
    before = dtw.launches
    got = dtw.dtw_cuda(a, b, la, lb)
    want = dtw.dtw_reference(a, b, la, lb)
    torch.cuda.synchronize()
    assert dtw.launches == before + 1
    assert torch.equal(got, want)
    assert torch.equal(dtw.dtw_batch(a, b, la, lb, device=dev), got)


@pytest.mark.cuda
def test_dtw_cuda_checks_its_inputs_on_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernel has no CPU mode)")
    dev = torch.device("cuda")
    a = torch.zeros(4, 8, device=dev)
    n = torch.full((4,), 8, dtype=torch.int32, device=dev)
    with pytest.raises(TypeError):
        dtw.dtw_cuda(a.double(), a.double(), n, n)
    with pytest.raises(TypeError):
        dtw.dtw_cuda(a, a, n.long(), n.long())
    with pytest.raises(ValueError, match="contiguous"):
        dtw.dtw_cuda(a.t().contiguous().t(), a, n, n)
    with pytest.raises(ValueError, match="widest"):
        wide = torch.zeros(1, 1 << 20, device=dev)
        one = torch.ones(1, dtype=torch.int32, device=dev)
        dtw.dtw_cuda(wide, wide, one, one)
