"""Shared building blocks for the backbones.

Counterpart of ``deepards_tpu/models/layers.py``.  Conventions:

- 1D backbones take and return (N, C, L), PyTorch's layout for
  ``conv1d``; the 2D ones (N, C, H, W);
- ``BatchStatNorm`` always normalizes by the current batch's statistics
  (there are no running averages and no train/eval switch), computed in
  float32 (float64 for a float64 input) with the biased variance;
- the ``bn_row_mask`` scope carries a row-validity mask into every
  ``BatchStatNorm`` whose row count matches it, so pad rows drop out of the
  statistics and a padded batch normalizes its real rows exactly as a
  true-size batch would.
"""
import contextlib
import contextvars
import math
from typing import NamedTuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from deepards_tpu_torch.parallel import mesh

# Stack of row masks scoped by ``bn_row_mask``.  A ContextVar keeps scopes
# opened in different threads (the server's handler threads) apart.
_BN_ROW_MASK = contextvars.ContextVar("bn_row_mask", default=())


@contextlib.contextmanager
def bn_row_mask(mask):
    """Scope a per-row validity mask for BatchStatNorm statistics.

    ``mask`` has one entry per backbone row (B*S for windows folded into
    rows).  Within the scope, every BatchStatNorm whose rows per
    statistics group equal ``len(mask)`` computes mask-weighted mean and
    variance; norms over another row count ignore it.
    """
    if mask is None:
        yield
        return
    token = _BN_ROW_MASK.set(_BN_ROW_MASK.get() + (torch.as_tensor(mask),))
    try:
        yield
    finally:
        _BN_ROW_MASK.reset(token)


def current_bn_row_mask(n_rows):
    """The innermost scoped mask if one is set AND matches ``n_rows``."""
    stack = _BN_ROW_MASK.get()
    if not stack:
        return None
    mask = stack[-1]
    return mask if mask.shape[0] == n_rows else None


def conv_kernel_init(weight, generator=None):
    """Fill a conv weight (Cout, Cin, K) with normal(0, sqrt(2/(K*Cout))),
    the JAX package's conv initializer, drawn from ``generator``."""
    out_ch, _, k = weight.shape
    std = math.sqrt(2.0 / (k * out_ch))
    with torch.no_grad():
        weight.copy_(
            torch.randn(weight.shape, generator=generator) * std
        )
    return weight


# jax.nn.initializers.truncated_normal's stddev correction for a normal
# truncated at +-2 standard deviations
TRUNC_STD = 0.87962566103423978


def truncated_normal_(weight, std, generator=None):
    """Fill ``weight`` with a normal truncated at +-2 standard deviations
    whose standard deviation is ``std`` (flax's variance-scaling
    initializers): draws outside the truncation are drawn again."""
    with torch.no_grad():
        w = torch.randn(weight.shape, generator=generator)
        while True:
            out = w.abs() > 2
            if not out.any():
                break
            w[out] = torch.randn(int(out.sum()), generator=generator)
        weight.copy_(w * (std / TRUNC_STD))
    return weight


def dense_init(linear, generator=None):
    """A Dense layer's init as the JAX package's flax Dense has it: kernel
    normal(0, 1/sqrt(fan_in)) (the scale of flax's default lecun_normal,
    untruncated), bias 0, drawn from ``generator``."""
    w = linear.weight
    with torch.no_grad():
        w.copy_(torch.randn(w.shape, generator=generator)
                / math.sqrt(w.shape[1]))
        if linear.bias is not None:
            linear.bias.zero_()
    return linear


class SharedDraws(NamedTuple):
    """A dropout generator for ``copies`` equal stacks of rows: ``dropout``
    draws the mask of the first stack and repeats it for the others, so
    each stack sees the masks one call of its own would draw from the same
    generator state (the siamese towers' shared dropout key)."""

    generator: torch.Generator
    copies: int


def dropout(h, rate, generator):
    """Inverted dropout drawn from ``generator`` (which must live on
    ``h``'s device, or be ``SharedDraws`` of one): keep with probability
    1-rate, scale kept values.  Inside ``mesh.sharded_rows`` the rows are
    one rank's shard: the masks of every rank's rows are drawn and this
    rank's kept."""
    copies = 1
    if isinstance(generator, SharedDraws):
        generator, copies = generator
    keep_prob = 1.0 - rate
    rows = h.shape[0] // copies
    axis = mesh.current_sharding()
    if axis is None:
        shape = (rows,) + tuple(h.shape[1:])
        keep = torch.rand(shape, generator=generator, device=h.device)
    else:
        shape = (rows * axis.world,) + tuple(h.shape[1:])
        keep = torch.rand(shape, generator=generator, device=h.device)[
            axis.local(shape[0])]
    keep = keep < keep_prob
    if copies > 1:
        keep = keep.repeat((copies,) + (1,) * (h.ndim - 1))
    return torch.where(keep, h / keep_prob, torch.zeros_like(h))


def promoted_linear(x, linear):
    """``linear`` over ``x`` in the promoted type of the two, as flax's
    Dense computes a float32 input under bfloat16 params (and the
    reverse)."""
    dtype = torch.promote_types(x.dtype, linear.weight.dtype)
    bias = None if linear.bias is None else linear.bias.to(dtype)
    return F.linear(x.to(dtype), linear.weight.to(dtype), bias)


class SampleGroups(int):
    """A ``BatchStatNorm`` group count whose groups are whole samples
    (``bn_scope='sequence'``), which keep their statistics to themselves
    on every rank."""


class BatchStatNorm(nn.Module):
    """BatchNorm over (N, C, L), or (N, C, H, W) for the 2D networks, that
    always uses current-batch statistics: per channel over N and the
    spatial axes, a row mask over the N rows.

    ``forward(x, groups)`` splits the N rows into ``groups`` equal
    consecutive groups with statistics of their own: ``SampleGroups(B)``
    over B*S window rows gives each sample's S windows their own
    statistics (``bn_scope='sequence'``) in one grouped reduction.  Inside
    ``mesh.sharded_rows`` the rows are one rank's shard of the batch, and
    each group's sums and count (then its squared deviations) are summed
    over the ranks before the mean (then the variance), but for
    ``SampleGroups``: a sample never crosses a rank, so its statistics
    stay local, whatever the count of samples the rank holds.
    """

    def __init__(self, num_features, eps=1e-5):
        super().__init__()
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(num_features))
        self.bias = nn.Parameter(torch.zeros(num_features))

    def forward(self, x, groups=1):
        if x.ndim == 4:  # an image's H*W positions as one length
            return self.forward(x.flatten(2), groups).reshape(x.shape)
        n, c, length = x.shape
        rows = n // groups
        # float32 at least: a float64 model (a reference) stays float64
        stat_dtype = torch.promote_types(x.dtype, torch.float32)
        xf = x.to(stat_dtype).reshape(groups, rows, c, length)
        axes = (1, 3)
        row_mask = current_bn_row_mask(rows)
        # rows that are one rank's shard: statistics of every rank's rows
        sharded = (mesh.current_sharding() is not None
                   and not isinstance(groups, SampleGroups))
        if row_mask is None and sharded:
            row_mask = torch.ones(rows)
        if row_mask is not None:
            # mask-weighted statistics: pad rows contribute nothing
            m = row_mask.to(device=x.device, dtype=stat_dtype)
            m = m.reshape(1, rows, 1, 1)
            total = (xf * m).sum(dim=axes, keepdim=True)
            m_sum = m.sum()
            if sharded:
                both = mesh.global_sum(torch.cat([total.reshape(-1),
                                                  m_sum.reshape(1)]))
                total, m_sum = both[:-1].reshape(total.shape), both[-1]
            count = torch.clamp(m_sum, min=1.0) * float(length)
            mean = total / count
            square = ((xf - mean).square() * m).sum(dim=axes, keepdim=True)
            if sharded:
                square = mesh.global_sum(square)
            var = square / count
        else:
            var, mean = torch.var_mean(
                xf, dim=axes, correction=0, keepdim=True)
        y = (xf - mean) * torch.rsqrt(var + self.eps)
        y = y * self.weight.reshape(1, 1, c, 1) + self.bias.reshape(1, 1, c, 1)
        return y.reshape(n, c, length).to(x.dtype)


def linear_resize_weights(in_len, out_len):
    """(in_len, out_len) float64 weights of ``jax.image.resize(...,
    "linear")`` along one axis: the triangle kernel at the half-pixel
    centres, widened by the scale when downsampling (antialiasing), each
    column normalized over the inputs it reaches, and zero for an output
    centre outside the input (``jax.image.scale_and_translate``)."""
    scale = out_len / in_len
    inv_scale = 1.0 / scale
    kernel_scale = max(inv_scale, 1.0)
    sample = (np.arange(out_len) + 0.5) * inv_scale - 0.5
    x = np.abs(sample[None, :] - np.arange(in_len)[:, None]) / kernel_scale
    weights = np.maximum(0.0, 1.0 - x)
    total = weights.sum(axis=0, keepdims=True)
    weights = np.where(np.abs(total) > 1000.0 * np.finfo(np.float32).eps,
                       weights / np.where(total != 0, total, 1), 0.0)
    inside = (sample >= -0.5) & (sample <= in_len - 0.5)
    return np.where(inside[None, :], weights, 0.0)


def max_pool1d(x, window, stride, padding=0):
    """Max pool over L of (N, C, L); padding is -inf, so it never wins."""
    if padding:
        x = F.pad(x, (padding, padding), value=float("-inf"))
    return F.max_pool1d(x, window, stride)


def avg_pool1d(x, window, stride, padding=0):
    """Average pool over L of (N, C, L); zero padding counts in the mean."""
    return F.avg_pool1d(x, window, stride, padding, count_include_pad=True)


def global_avg_pool_flatten(x, window=7):
    """AvgPool1d(window, stride=1) then flatten: the backbone epilogue.
    Expects a final length equal to ``window``.  Flattens length-major,
    as the JAX package's (N, L, C) layout does."""
    x = avg_pool1d(x, window, 1)
    return x.transpose(1, 2).reshape(x.shape[0], -1)
