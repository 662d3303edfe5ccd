"""deepards_tpu_torch.models.layers against deepards_tpu.models.layers.

The JAX package runs (N, L, C); the port runs (N, C, L).  Inputs come
from numpy seeds; tolerance atol 1e-5 (f32 reductions in another order).
"""
import threading

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deepards_tpu.models import layers as jl
from deepards_tpu_torch.models import layers as tl

# parallel test workers share the cores: one torch thread each
torch.set_num_threads(1)

ATOL = 1e-5


def _to_jax(x):
    """(N, C, L) numpy -> (N, L, C) jax array."""
    return jnp.asarray(np.transpose(x, (0, 2, 1)))


def _from_jax(y):
    return np.transpose(np.asarray(y), (0, 2, 1))


def _norm_pair(rng, c):
    scale = rng.normal(size=c).astype(np.float32)
    bias = rng.normal(size=c).astype(np.float32)
    jparams = {"params": {"scale": jnp.asarray(scale),
                          "bias": jnp.asarray(bias)}}
    norm = tl.BatchStatNorm(c)
    with torch.no_grad():
        norm.weight.copy_(torch.from_numpy(scale))
        norm.bias.copy_(torch.from_numpy(bias))
    return jparams, norm


def test_batch_stat_norm_matches_jax():
    rng = np.random.default_rng(0)
    x = (rng.normal(size=(8, 4, 10)) * 3 + 1).astype(np.float32)
    jparams, norm = _norm_pair(rng, 4)
    want = _from_jax(jl.BatchStatNorm().apply(jparams, _to_jax(x)))
    got = norm(torch.from_numpy(x)).detach().numpy()
    np.testing.assert_allclose(got, want, atol=ATOL, rtol=0)


def test_batch_stat_norm_masked_matches_jax_and_true_size():
    """Masked statistics over a padded batch == a true-size batch, and
    == the JAX package's masked norm (pad rows carry garbage)."""
    rng = np.random.default_rng(1)
    x = rng.normal(size=(8, 4, 10)).astype(np.float32)
    x[5:] = 7.5
    mask = np.array([1, 1, 1, 1, 1, 0, 0, 0], np.float32)
    jparams, norm = _norm_pair(rng, 4)
    with jl.bn_row_mask(jnp.asarray(mask)):
        want = _from_jax(jl.BatchStatNorm().apply(jparams, _to_jax(x)))
    with torch.no_grad():
        true_size = norm(torch.from_numpy(x[:5])).numpy()
        with tl.bn_row_mask(torch.from_numpy(mask)):
            got = norm(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got[:5], true_size, atol=1e-6, rtol=1e-6)
    np.testing.assert_allclose(got, want, atol=ATOL, rtol=0)


@pytest.mark.parametrize("masked", [False, True])
def test_batch_stat_norm_float64_keeps_float64(masked):
    """A float64 norm (the reference of a float32 comparison) computes its
    statistics in float64: it equals numpy's float64 norm to 1e-12."""
    rng = np.random.default_rng(5)
    x = rng.normal(size=(8, 3, 11)) * 3 + 1
    mask = np.float64([1, 1, 1, 1, 1, 1, 0, 0]) if masked else np.ones(8)
    norm = tl.BatchStatNorm(3).double()
    with torch.no_grad(), tl.bn_row_mask(
            torch.from_numpy(mask) if masked else None):
        got = norm(torch.from_numpy(x))
    m = mask.reshape(-1, 1, 1)
    mean = (x * m).sum(axis=(0, 2), keepdims=True) / (m.sum() * 11)
    var = (((x - mean) ** 2) * m).sum(axis=(0, 2), keepdims=True) / (
        m.sum() * 11)
    assert got.dtype == torch.float64
    np.testing.assert_allclose(got.numpy(), (x - mean) / np.sqrt(var + 1e-5),
                               atol=1e-12, rtol=0)


def test_batch_stat_norm_all_ones_mask_is_noop():
    rng = np.random.default_rng(2)
    x = torch.from_numpy(rng.normal(size=(6, 3, 7)).astype(np.float32))
    norm = tl.BatchStatNorm(3)
    with torch.no_grad():
        plain = norm(x)
        with tl.bn_row_mask(torch.ones(6)):
            masked = norm(x)
    np.testing.assert_allclose(plain.numpy(), masked.numpy(), atol=1e-6,
                               rtol=0)


def test_batch_stat_norm_mismatched_mask_ignored():
    rng = np.random.default_rng(3)
    x = torch.from_numpy(rng.normal(size=(6, 3, 7)).astype(np.float32))
    norm = tl.BatchStatNorm(3)
    with torch.no_grad():
        plain = norm(x)
        with tl.bn_row_mask(torch.ones(16)):
            masked = norm(x)
    assert torch.equal(plain, masked)


def test_batch_stat_norm_groups_match_per_group_calls():
    """groups=G gives each block of N/G rows its own statistics, as
    separate calls on each block do (the bn_scope='sequence' form)."""
    rng = np.random.default_rng(4)
    x = torch.from_numpy(rng.normal(size=(12, 5, 9)).astype(np.float32))
    norm = tl.BatchStatNorm(5)
    with torch.no_grad():
        grouped = norm(x, groups=3)
        separate = torch.cat([norm(x[i:i + 4]) for i in (0, 4, 8)])
    np.testing.assert_allclose(grouped.numpy(), separate.numpy(),
                               atol=1e-6, rtol=0)


def test_bn_row_mask_scope_is_per_thread_and_popped():
    seen = []
    with tl.bn_row_mask(torch.ones(4)):
        t = threading.Thread(
            target=lambda: seen.append(tl.current_bn_row_mask(4)))
        t.start()
        t.join(timeout=10)
        assert tl.current_bn_row_mask(4) is not None
        assert tl.current_bn_row_mask(5) is None
    assert seen == [None]
    assert tl.current_bn_row_mask(4) is None


@pytest.mark.parametrize("window,stride,padding", [(3, 2, 1), (2, 2, 0),
                                                    (3, 1, 0)])
def test_pools_match_flax(window, stride, padding):
    rng = np.random.default_rng(5)
    x = rng.normal(size=(3, 4, 17)).astype(np.float32)
    xt = torch.from_numpy(x)
    np.testing.assert_allclose(
        tl.max_pool1d(xt, window, stride, padding).numpy(),
        _from_jax(jl.max_pool1d(_to_jax(x), window, stride, padding)),
        atol=ATOL, rtol=0)
    np.testing.assert_allclose(
        tl.avg_pool1d(xt, window, stride, padding).numpy(),
        _from_jax(jl.avg_pool1d(_to_jax(x), window, stride, padding)),
        atol=ATOL, rtol=0)


@pytest.mark.parametrize("length", [7, 9])
def test_global_avg_pool_flatten_matches_flax(length):
    """Same values in the same (length-major) order."""
    rng = np.random.default_rng(6)
    x = rng.normal(size=(2, 5, length)).astype(np.float32)
    np.testing.assert_allclose(
        tl.global_avg_pool_flatten(torch.from_numpy(x)).numpy(),
        np.asarray(jl.global_avg_pool_flatten(_to_jax(x))),
        atol=ATOL, rtol=0)


def test_conv_kernel_init_scale_and_seed():
    w = torch.empty(256, 64, 7)
    tl.conv_kernel_init(w, torch.Generator().manual_seed(0))
    std = np.sqrt(2.0 / (7 * 256))
    assert abs(float(w.std()) / std - 1.0) < 0.02
    assert abs(float(w.mean())) < 0.02 * std
    again = tl.conv_kernel_init(torch.empty(256, 64, 7),
                                torch.Generator().manual_seed(0))
    assert torch.equal(w, again)
    # the same scale rule as the JAX package's initializer
    jw = np.asarray(jl.conv_kernel_init(7)(jax.random.PRNGKey(0),
                                           (7, 64, 256)))
    assert abs(jw.std() / std - 1.0) < 0.02
