"""Transformer encoder core: multi-head self-attention and feed-forward
blocks, each post-norm residual.

Counterpart of ``deepards_tpu/models/transformer.py``, with its arithmetic:

- the attention scores are computed in float32 (the JAX einsum's
  ``preferred_element_type``: bfloat16 operands widened before the
  product), then divided by sqrt(head_size); a masked key's score is the
  dtype's most negative value; the softmax runs in float32 and its
  weights are cast to v's dtype for the second product;
- heads are split as ``reshape(b, s, heads, head_size)``;
- the block's second residual adds the block's input ``x``, not the
  attended value;
- ``LayerNorm`` is flax's: eps 1e-6, the variance as E[x^2] - E[x]^2
  clipped at 0, statistics and normalization in at least float32, the
  result in the input's (and params') dtype.

Attention is two matmuls and a softmax, as the JAX package leaves it to
XLA.  Dense layers compute in the promoted type of input and params, as
flax's Dense does.
"""
import math

import torch
import torch.nn.functional as F
from torch import nn

from deepards_tpu_torch.models.layers import (
    dense_init,
    dropout,
    promoted_linear,
)


class LayerNorm(nn.Module):
    """flax's ``nn.LayerNorm()`` over the last axis (scale and bias)."""

    def __init__(self, features, eps=1e-6):
        super().__init__()
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(features))
        self.bias = nn.Parameter(torch.zeros(features))

    def reset_parameters(self):
        nn.init.ones_(self.weight)
        nn.init.zeros_(self.bias)

    def forward(self, x):
        dtype = torch.promote_types(x.dtype, torch.float32)
        xf = x.to(dtype)
        mean = xf.mean(dim=-1, keepdim=True)
        var = torch.clamp((xf * xf).mean(dim=-1, keepdim=True) - mean * mean,
                          min=0.0)
        y = (xf - mean) * (torch.rsqrt(var + self.eps)
                           * self.weight.to(dtype))
        y = y + self.bias.to(dtype)
        return y.to(torch.promote_types(x.dtype, self.weight.dtype))


class MultiHeadAttention(nn.Module):
    """Project q, k, v to ``hidden_size`` over ``num_heads`` heads, scaled
    dot-product attention, project back to ``input_size``."""

    def __init__(self, input_size, hidden_size, num_heads):
        super().__init__()
        self.hidden_size = hidden_size
        self.num_heads = num_heads
        self.q_linear = nn.Linear(input_size, hidden_size)
        self.k_linear = nn.Linear(input_size, hidden_size)
        self.v_linear = nn.Linear(input_size, hidden_size)
        self.joint_linear = nn.Linear(hidden_size, input_size)

    def forward(self, q, k, v, mask=None):
        """``mask``: optional (B, S) True-for-valid key mask."""
        b, s, _ = q.shape
        head_size = self.hidden_size // self.num_heads

        def proj(x, linear):
            h = promoted_linear(x, linear)
            return h.reshape(b, s, self.num_heads, head_size).transpose(1, 2)

        qp = proj(q, self.q_linear)
        kp = proj(k, self.k_linear)
        vp = proj(v, self.v_linear)
        score_dtype = torch.promote_types(qp.dtype, torch.float32)
        weights = torch.matmul(qp.to(score_dtype),
                               kp.to(score_dtype).transpose(-1, -2))
        weights = weights / math.sqrt(head_size)
        if mask is not None:
            weights = torch.where(mask[:, None, None, :], weights,
                                  torch.finfo(weights.dtype).min)
        weights = torch.softmax(weights, dim=-1)
        out = torch.matmul(weights.to(vp.dtype), vp)
        out = out.transpose(1, 2).reshape(b, s, self.hidden_size)
        return promoted_linear(out, self.joint_linear)


class Block(nn.Module):
    """Attention, dropout, LayerNorm of it plus ``x``; Dense, ReLU, Dense,
    dropout, LayerNorm of that plus ``x``.  ``norms`` and ``dense`` are
    flax's ``LayerNorm_k`` and ``Dense_k``."""

    def __init__(self, input_size, hidden_size, num_heads, dropout=0.2):
        super().__init__()
        self.dropout = dropout
        self.attention = MultiHeadAttention(input_size, hidden_size,
                                            num_heads)
        self.norms = nn.ModuleList([LayerNorm(input_size),
                                    LayerNorm(input_size)])
        self.dense = nn.ModuleList([nn.Linear(input_size, hidden_size),
                                    nn.Linear(hidden_size, input_size)])

    def _drop(self, h, deterministic, generator):
        if self.dropout > 0 and not deterministic:
            return dropout(h, self.dropout, generator)
        return h

    def forward(self, x, deterministic=False, generator=None, mask=None):
        att = self.attention(x, x, x, mask)
        att = self._drop(att, deterministic, generator)
        attended = self.norms[0](att + x)
        h = F.relu(promoted_linear(attended, self.dense[0]))
        h = promoted_linear(h, self.dense[1])
        h = self._drop(h, deterministic, generator)
        return self.norms[1](h + x)


class Transformer(nn.Module):
    """``num_blocks`` blocks in sequence: (B, S, input_size) in and out."""

    def __init__(self, input_size, hidden_size, num_blocks, num_heads=4,
                 dropout=0.2):
        super().__init__()
        self.blocks = nn.ModuleList(
            Block(input_size, hidden_size, num_heads, dropout)
            for _ in range(num_blocks))

    def reset_parameters(self, generator=None):
        """flax's init: Dense kernels lecun normal (``dense_init``) and
        biases 0, LayerNorm scale 1 and bias 0."""
        for mod in self.modules():
            if isinstance(mod, nn.Linear):
                dense_init(mod, generator)
            elif isinstance(mod, LayerNorm):
                mod.reset_parameters()
        return self

    def forward(self, x, deterministic=False, generator=None, mask=None):
        for block in self.blocks:
            x = block(x, deterministic, generator, mask)
        return x
