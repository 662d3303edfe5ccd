"""DTW of the port against the JAX package.

``dtw_reference`` is held to JAX ``dtw_scan`` and to the TPU kernel's body
run by ``dtw_pallas(..., interpret=True)`` at rtol 1e-6 (every operation
is an exact f32 subtract, abs, min or add, so they agree bit for bit in
practice), and to the f64 numpy oracle at rtol 1e-4.  The pair scoring of
``dtw/lib.py`` is held to ``deepards_tpu.dtw.lib``.  The CUDA kernel
itself runs only on a card (``test_torch_dtw_cuda.py`` and chip_smoke.py).
"""
import numpy as np
import pandas as pd
import pytest
import torch

from deepards_tpu.dtw import lib as jlib
from deepards_tpu.ops import dtw as jdtw
from deepards_tpu_torch.dtw import lib
from deepards_tpu_torch.ops import dtw

# parallel test workers share the cores: one torch thread each
torch.set_num_threads(1)

EXACT = dict(rtol=1e-6, atol=0)
ORACLE = dict(rtol=1e-4)


def _pairs(seed, bsz, n, lo):
    rng = np.random.default_rng(seed)
    a = rng.normal(size=(bsz, n)).astype(np.float32)
    b = rng.normal(size=(bsz, n)).astype(np.float32)
    la = rng.integers(lo, n + 1, size=bsz).astype(np.int32)
    lb = rng.integers(lo, n + 1, size=bsz).astype(np.int32)
    a[np.arange(n)[None, :] >= la[:, None]] = 0
    b[np.arange(n)[None, :] >= lb[:, None]] = 0
    return a, b, la, lb


def _reference(a, b, la, lb):
    return dtw.dtw_reference(*(torch.from_numpy(x) for x in (a, b, la, lb))
                             ).numpy()


# (seed, B, n, shortest length): the tests/test_dtw.py fixture shape, n = 1,
# ragged n not a multiple of 32 or 64, lengths down to 1, and n = 257 (one
# row past the CUDA kernel's first strip of 256)
CASES = [(3, 6, 48, 20), (0, 4, 1, 1), (5, 9, 97, 1), (7, 5, 33, 30),
         (1, 3, 257, 1)]


@pytest.mark.parametrize("seed,bsz,n,lo", CASES)
def test_reference_matches_jax_scan_pallas_and_oracle(seed, bsz, n, lo):
    a, b, la, lb = _pairs(seed, bsz, n, lo)
    got = _reference(a, b, la, lb)
    np.testing.assert_allclose(
        got, np.asarray(jdtw.dtw_scan(a, b, la, lb)), **EXACT)
    np.testing.assert_allclose(
        got, np.asarray(jdtw.dtw_pallas(a, b, la, lb, block_b=8,
                                        interpret=True)), **EXACT)
    oracle = np.array([jdtw.dtw_numpy(a[i, :la[i]], b[i, :lb[i]])
                       for i in range(bsz)])
    np.testing.assert_allclose(got, oracle, **ORACLE)
    np.testing.assert_allclose(
        got, [dtw.dtw_numpy(a[i, :la[i]], b[i, :lb[i]]) for i in range(bsz)],
        **ORACLE)


def test_pad_rows_of_length_one_give_first_cost():
    a, b, la, lb = _pairs(8, 6, 40, 10)
    la[3:] = 1
    lb[3:] = 1
    got = _reference(a, b, la, lb)
    np.testing.assert_array_equal(got[3:], np.abs(a[3:, 0] - b[3:, 0]))
    np.testing.assert_allclose(got, np.asarray(jdtw.dtw_scan(a, b, la, lb)),
                               **EXACT)


def test_dtw_batch_cpu_defaults_and_one_dimensional_input():
    rng = np.random.default_rng(9)
    a = rng.normal(size=(3, 32)).astype(np.float32)
    b = rng.normal(size=(3, 32)).astype(np.float32)
    got = dtw.dtw_batch(a, b, device="cpu")
    assert got.device.type == "cpu" and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(jdtw.dtw_scan(a, b)),
                               **EXACT)
    one = dtw.dtw_batch(a[0], b[0], device="cpu")
    assert one.shape == (1,) and float(one[0]) == float(got[0])


def test_identical_sequences_score_zero():
    a, _, la, _ = _pairs(10, 5, 48, 20)
    assert (_reference(a, a, la, la) == 0).all()


def test_batched_dtw_pairs_matches_jax_lib():
    """Length-sorted, bucketed chunks (a long outlier, a pair count that
    forces batch padding, a tiny chunk forcing several dispatches)."""
    rng = np.random.default_rng(11)
    lens = list(rng.integers(25, 90, size=13)) + [301]
    seqs_a = [rng.normal(size=n).astype(np.float32) for n in lens]
    seqs_b = [rng.normal(size=n).astype(np.float32) for n in lens]
    want = jlib.batched_dtw_pairs(seqs_a, seqs_b)
    for chunk in (5, 8192):
        got = lib.batched_dtw_pairs(seqs_a, seqs_b, chunk=chunk,
                                    device="cpu")
        assert got.dtype == np.float64
        np.testing.assert_allclose(got, want, **EXACT)


def test_pad_pairs_matches_jax_lib():
    rng = np.random.default_rng(12)
    seqs_a = [rng.normal(size=n) for n in (5, 70, 3)]
    seqs_b = [rng.normal(size=n) for n in (9, 1, 65)]
    for got, want in zip(lib._pad_pairs(seqs_a, seqs_b),
                         jlib._pad_pairs(seqs_a, seqs_b)):
        np.testing.assert_array_equal(got, want)
        assert got.dtype == want.dtype


def test_per_breath_scores_match_jax_lib():
    rng = np.random.default_rng(2)
    breaths = [rng.normal(size=rng.integers(30, 60)) for _ in range(10)]
    got = lib.per_breath_dtw_scores(breaths, n_breaths=3, device="cpu")
    want = jlib.per_breath_dtw_scores(breaths, n_breaths=3)
    assert np.isnan(got[:3]).all()
    np.testing.assert_allclose(got[3:], want[3:], **EXACT)
    short = lib.per_breath_dtw_scores(breaths[:3], n_breaths=3,
                                      device="cpu")
    assert np.isnan(short).all()


@pytest.mark.parametrize("rolling", [1, 3])
def test_dtw_analyze_matches_jax_lib(rolling):
    """The port takes the prediction rows' window indices and hours as
    arrays (window 11 has two rows, whose hours its breaths cycle through)
    and returns arrays equal to the JAX package's frame."""
    rng = np.random.default_rng(13)
    pt_data = rng.normal(size=(4, 3, 1, 40)).astype(np.float32)
    obs = np.array([10, 11, 11, 12, 13])
    hours = np.array([0.5, 1.5, 1.75, 2.5, 3.5])
    got = lib.dtw_analyze(pt_data, 3, rolling, obs, hours, device="cpu")
    want = jlib.dtw_analyze(pt_data, 3, rolling,
                            pd.DataFrame({"hour": hours}, index=obs))
    assert isinstance(got, lib.DTWFrame)
    np.testing.assert_array_equal(got.index, want.index.to_numpy())
    np.testing.assert_allclose(got.dtw, want.dtw.to_numpy(), **EXACT)
    np.testing.assert_array_equal(got.hour, want.hour.to_numpy())
    assert got.index.dtype == np.int64 and len(got.index) == 12
