"""The CUDA DTW kernel on the card, against its plain PyTorch version.

The kernel has no CPU mode, so these tests carry the ``cuda`` marker and
skip without a card.  The file imports no JAX, so it runs on a machine
with the card but without JAX:

    python -m pytest tests/test_torch_dtw_cuda.py -m cuda --noconftest -q

Every comparison is exact (``torch.equal``): each cell is the same f32
subtract, abs, min, min and add in both versions.  The widths cover both
of the kernel's paths (one warp per pair up to n = 256, one block of
strip warps above) and their edges: one lane, one warp, one strip, a
second strip, several strip passes (n > 8192).
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


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernel has no CPU mode)")
    return torch.device("cuda")


def _on(dev, *arrays):
    return [torch.from_numpy(x).to(dev) for x in arrays]


def _exact(a, b, la, lb):
    got = dtw.dtw_cuda(a, b, la, lb)
    want = dtw.dtw_reference(a, b, la, lb)
    torch.cuda.synchronize()
    assert torch.isfinite(got).all()
    assert torch.equal(got, want), float((got - want).abs().max())
    return got


@pytest.mark.cuda
@pytest.mark.parametrize("bsz,n,lo", [(300, 97, 1), (512, 256, 150),
                                      (16, 1000, 1)])
def test_dtw_cuda_equals_reference_on_card(bsz, n, lo):
    dev = _card()
    a, b, la, lb = _on(dev, *_pairs(14, bsz, n, lo))
    before = dtw.launches
    got = _exact(a, b, la, lb)
    assert dtw.launches == before + 1
    assert torch.equal(dtw.dtw_batch(a, b, la, lb, device=dev), got)


@pytest.mark.cuda
@pytest.mark.parametrize("bsz,n", [(4, 1), (8, 31), (8, 32), (8, 33),
                                   (8, 255), (8, 256), (8, 257), (6, 4480)])
def test_dtw_cuda_at_lane_warp_and_strip_edges_on_card(bsz, n):
    dev = _card()
    a, b, la, lb = _pairs(n, bsz, n, 1)
    la[0] = lb[1] = n  # full length on one side, ragged on the other
    la[2] = lb[2] = n
    _exact(*_on(dev, a, b, la, lb))
    assert dtw.dtw_resident_warps(n) > 0  # the kernel fits an SM


@pytest.mark.cuda
def test_dtw_cuda_beyond_the_old_width_limit_on_card():
    """n = 12,288 needs two passes of strips (the old kernel's limit was
    11,622, one block's shared memory)."""
    dev = _card()
    a, b, la, lb = _pairs(21, 1, 12288, 12288)
    _exact(*_on(dev, a, b, la, lb))


@pytest.mark.cuda
@pytest.mark.parametrize("n", [256, 1000])
def test_dtw_cuda_one_row_or_one_column_on_card(n):
    dev = _card()
    a, b, _, _ = _pairs(22, 2, n, n)
    la = np.array([1, n], np.int32)
    lb = np.array([n, 1], np.int32)
    a[0, 1:] = 0
    b[1, 1:] = 0
    _exact(*_on(dev, a, b, la, lb))


@pytest.mark.cuda
@pytest.mark.parametrize("n", [256, 4480])
def test_dtw_cuda_pad_rows_and_mixed_lengths_on_card(n):
    """A chunk as batched_dtw_pairs builds it: ragged pairs of every
    length class, then pad rows of length 1."""
    dev = _card()
    a, b, la, lb = _pairs(23, 40, n, 1)
    la[:8] = [1, 2, 31, 32, 33, n // 2, n - 1, n]
    lb[:8] = [n, n - 1, 33, 1, 32, 2, n // 3, n]
    la[30:] = lb[30:] = 1
    a[np.arange(n)[None, :] >= la[:, None]] = 0
    b[np.arange(n)[None, :] >= lb[:, None]] = 0
    got = _exact(*_on(dev, a, b, la, lb))
    assert torch.equal(got[30:].cpu(), torch.from_numpy(
        np.abs(a[30:, 0] - b[30:, 0])))


@pytest.mark.cuda
@pytest.mark.parametrize("bsz,n", [(512, 256), (16, 1000), (2, 9000)])
def test_dtw_cuda_repeats_bit_for_bit_on_card(bsz, n):
    """Twenty launches give one answer: a guard against a race in the
    strip hand-off."""
    dev = _card()
    a, b, la, lb = _on(dev, *_pairs(24, bsz, n, 1))
    first = _exact(a, b, la, lb)
    for _ in range(20):
        assert torch.equal(dtw.dtw_cuda(a, b, la, lb), first)


@pytest.mark.cuda
def test_dtw_cuda_checks_its_inputs_on_card():
    dev = _card()
    a = torch.zeros(4, 8, device=dev)
    n = torch.full((4,), 8, dtype=torch.int32, device=dev)
    with pytest.raises(TypeError):
        dtw.dtw_cuda(a.double(), a.double(), n, n)
    with pytest.raises(TypeError):
        dtw.dtw_cuda(a, a, n.long(), n.long())
    with pytest.raises(ValueError, match="contiguous"):
        dtw.dtw_cuda(a.t().contiguous().t(), a, n, n)
    with pytest.raises(ValueError, match="shape"):
        dtw.dtw_cuda(a, a[:, :4].contiguous(), n, n)
    bad = torch.tensor([0, 9, 8, 1], dtype=torch.int32, device=dev)
    got = dtw.dtw_cuda(a, a, bad, n)
    assert torch.isnan(got[:2]).all() and torch.isfinite(got[2:]).all()
