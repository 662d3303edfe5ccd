"""Convolutional autoencoder with max-unpooling, and its encoder as a
backbone.

Counterpart of ``deepards_tpu/models/autoencoder_cnn.py``.  The encoder is
four stages of a 3-wide conv with a bias, a batch-statistic norm and a
2-wide max pool (no ReLU).  ``max_pool_with_argmax`` keeps each pool
window's winner as a one-hot over its two positions, a tie going to the
first, as torch's ``MaxPool1d(return_indices=True)``; ``max_unpool``
puts each value back at its winner and zeros at the other position.

The decoder's layers are flax's ``nn.ConvTranspose(kernel 3, padding
"SAME")`` with stride 1 and flax's default ``transpose_kernel=False``:
``lax.conv_transpose`` at stride 1 pads 1 on each side and correlates
with the kernel unflipped, which is ``F.conv1d`` with padding 1 and the
kernel (3, Cin, Cout) laid out as (Cout, Cin, 3), the layout of every
transplanted conv.  (``torch.nn.ConvTranspose1d`` with that kernel would
flip it.)  So ``deconvs[k]``, flax's ``ConvTranspose_k``, are
``nn.Conv1d``s.

``convs[k]`` and ``norms[k]`` are ``Conv1d_k`` and ``BatchStatNorm_k``.
Input and output layout is (N, C, L), L a multiple of 16 (224).
"""
import math

import torch
from torch import nn

from deepards_tpu_torch.models.layers import (
    BatchStatNorm,
    conv_kernel_init,
    max_pool1d,
    truncated_normal_,
)

WIDTHS = (64, 128, 256, 512)


def max_pool_with_argmax(x):
    """(N, C, L) -> pooled (N, C, L/2) and the winners' one-hot (N, C,
    L/2, 2), the first of two equal values winning."""
    n, c, length = x.shape
    xr = x.reshape(n, c, length // 2, 2)
    pooled = xr.amax(dim=-1)
    first = (xr[..., 0] == pooled).to(x.dtype)
    second = (xr[..., 1] == pooled).to(x.dtype) * (1 - first)
    return pooled, torch.stack([first, second], dim=-1)


def max_unpool(x, onehot):
    """The inverse of ``max_pool_with_argmax``: (N, C, L/2) -> (N, C, L)."""
    n, c, half = x.shape
    return (x[..., None] * onehot).reshape(n, c, 2 * half)


class _Encoder(nn.Module):
    def __init__(self, in_channels):
        super().__init__()
        self.in_channels = in_channels
        ins = (in_channels,) + WIDTHS[:-1]
        self.convs = nn.ModuleList(
            nn.Conv1d(i, o, 3, padding=1) for i, o in zip(ins, WIDTHS))
        self.norms = nn.ModuleList(BatchStatNorm(o) for o in WIDTHS)
        self.n_out_filters = WIDTHS[-1]

    def reset_parameters(self, generator=None):
        """The JAX package's initialization: the encoder's conv kernels
        from ``conv_kernel_init``, the decoder's flax's default for
        ``ConvTranspose`` (lecun normal: truncated, variance 1 / fan_in),
        conv biases 0, norm scale 1 and bias 0."""
        for conv in self.convs:
            conv_kernel_init(conv.weight, generator)
        for deconv in getattr(self, "deconvs", ()):
            fan_in = deconv.weight.shape[1] * deconv.weight.shape[2]
            truncated_normal_(deconv.weight, math.sqrt(1.0 / fan_in),
                              generator)
        for mod in self.modules():
            if isinstance(mod, nn.Conv1d):
                nn.init.zeros_(mod.bias)
            elif isinstance(mod, BatchStatNorm):
                nn.init.ones_(mod.weight)
                nn.init.zeros_(mod.bias)
        return self


class AutoencoderCNNEncoder(_Encoder):
    """The registry's ``basic_cnn_ae`` backbone: the encoder, then the
    maximum over the remaining length: (N, C, 224) -> (N, 512)."""

    def __init__(self, in_channels=1):
        super().__init__(in_channels)

    def forward(self, x, deterministic=False, generator=None, groups=1):
        h = x
        for conv, norm in zip(self.convs, self.norms):
            h = max_pool1d(norm(conv(h), groups), 2, 2)
        return h.amax(dim=2)


class AutoencoderCNN(_Encoder):
    """The full autoencoder: (N, C, L) -> its reconstruction (N, C, L)."""

    def __init__(self, in_channels=1):
        super().__init__(in_channels)
        outs = WIDTHS[-2::-1] + (in_channels,)
        self.deconvs = nn.ModuleList(
            nn.Conv1d(i, o, 3, padding=1)
            for i, o in zip(WIDTHS[::-1], outs))

    def forward(self, x, deterministic=False, generator=None, groups=1):
        h, winners = x, []
        for conv, norm in zip(self.convs, self.norms):
            h, onehot = max_pool_with_argmax(norm(conv(h), groups))
            winners.append(onehot)
        for deconv, onehot in zip(self.deconvs, reversed(winners)):
            h = deconv(max_unpool(h, onehot))
        return h
