"""Squeeze-and-excitation networks in 1D (senet18/154, se_resnet*,
se_resnext*).

Counterpart of ``deepards_tpu/models/senet1d.py``: a stem (three 3-wide
convs, or one 7-wide), a ceil-mode max pool (the length padded on the
right with -inf, so the pad never wins), four stages of SE blocks that
double the planes and halve the length, the 7-wide average pool, and
dropout where ``dropout_p`` is set.  Every block ends with ``SEModule``:
the channels' mean over the length, a 1x1 bottleneck MLP and a sigmoid
that scales each channel, before the residual.  Input and output layout
is (N, C, L); the final pool needs L = 224.

As in the ResNet port, the stem and every block hold their convs and
norms in lists in the JAX package's creation order (``Conv1d_k`` is
``convs[k]``): a block's main path, then its downsample, whose conv and
norm come last; ``se`` is its ``SEModule_0``.  Every call takes
``groups`` (see ``BatchStatNorm``).
"""
import functools
import math

import torch
import torch.nn.functional as F
from torch import nn

from deepards_tpu_torch.models.layers import (
    BatchStatNorm,
    conv_kernel_init,
    dropout,
    global_avg_pool_flatten,
    max_pool1d,
)


class SEModule(nn.Module):
    """Channel gate: mean over L -> 1x1 conv to channels // reduction ->
    ReLU -> 1x1 conv back -> sigmoid, times the input."""

    def __init__(self, channels, reduction):
        super().__init__()
        self.convs = nn.ModuleList([
            nn.Conv1d(channels, channels // reduction, 1),
            nn.Conv1d(channels // reduction, channels, 1)])

    def forward(self, x):
        s = F.relu(self.convs[0](x.mean(dim=2, keepdim=True)))
        return x * torch.sigmoid(self.convs[1](s))


class _SEBlock(nn.Module):
    """The main path's convs (``main_path``: (out, kernel, stride,
    padding, groups) each), a norm after each and ReLU between them; the
    downsample conv and norm; the SE gate; the residual; ReLU."""

    expansion = 1

    def __init__(self, inplanes, planes, groups, reduction, stride=1,
                 downsample=False, downsample_kernel_size=1,
                 downsample_padding=0):
        super().__init__()
        specs = self.main_path(planes, groups, stride)
        out = planes * self.expansion
        if downsample:
            specs.append((out, downsample_kernel_size, stride,
                          downsample_padding, 1))
        convs, cin = [], inplanes
        for k, (cout, kernel, s, pad, g) in enumerate(specs):
            # the downsample reads the block's input
            if downsample and k == len(specs) - 1:
                cin = inplanes
            convs.append(nn.Conv1d(cin, cout, kernel, stride=s, padding=pad,
                                   groups=g, bias=False))
            cin = cout
        self.convs = nn.ModuleList(convs)
        self.norms = nn.ModuleList(BatchStatNorm(spec[0]) for spec in specs)
        self.downsample = downsample
        self.se = SEModule(out, reduction)

    def forward(self, x, groups=1):
        n_main = len(self.convs) - (1 if self.downsample else 0)
        h = x
        for k in range(n_main):
            h = self.norms[k](self.convs[k](h), groups)
            if k < n_main - 1:
                h = F.relu(h)
        residual = x
        if self.downsample:
            residual = self.norms[-1](self.convs[-1](x), groups)
        return F.relu(self.se(h) + residual)


class SEBasicBlock(_SEBlock):
    expansion = 1

    @staticmethod
    def main_path(planes, groups, stride):
        return [(planes, 3, stride, 1, groups), (planes, 3, 1, 1, groups)]


class SEBottleneck(_SEBlock):
    """SENet154's bottleneck (reference: senet.py:98-120)."""

    expansion = 4

    @staticmethod
    def main_path(planes, groups, stride):
        return [(planes * 2, 1, 1, 0, 1), (planes * 4, 3, stride, 1, groups),
                (planes * 4, 1, 1, 0, 1)]


class SEResNetBottleneck(_SEBlock):
    """(reference: senet.py:122-145)"""

    expansion = 4

    @staticmethod
    def main_path(planes, groups, stride):
        return [(planes, 1, stride, 0, 1), (planes, 3, 1, 1, groups),
                (planes * 4, 1, 1, 0, 1)]


class SEResNeXtBottleneck(_SEBlock):
    """(reference: senet.py:147-168); base width 4."""

    expansion = 4

    @staticmethod
    def main_path(planes, groups, stride, base_width=4):
        width = int(math.floor(planes * (base_width / 64))) * groups
        return [(width, 1, 1, 0, 1), (width, 3, stride, 1, groups),
                (planes * 4, 1, 1, 0, 1)]


class SENet1D(nn.Module):
    def __init__(self, block_cls=SEBasicBlock, layers=(2, 2, 2, 2),
                 groups=64, reduction=4, dropout_p=0.2, inplanes=128,
                 input_3x3=True, downsample_kernel_size=3,
                 downsample_padding=1, in_channels=1):
        super().__init__()
        self.layers, self.groups = tuple(layers), groups
        self.reduction, self.dropout_p = reduction, dropout_p
        self.inplanes, self.input_3x3 = inplanes, input_3x3
        self.downsample_kernel_size = downsample_kernel_size
        self.downsample_padding = downsample_padding
        self.in_channels = in_channels
        if input_3x3:
            stem = [(in_channels, 64, 3, 2, 1), (64, 64, 3, 1, 1),
                    (64, inplanes, 3, 1, 1)]
        else:
            stem = [(in_channels, inplanes, 7, 2, 3)]
        self.convs = nn.ModuleList(
            nn.Conv1d(i, o, k, stride=s, padding=p, bias=False)
            for i, o, k, s, p in stem)
        self.norms = nn.ModuleList(BatchStatNorm(spec[1]) for spec in stem)
        blocks = []
        exp = block_cls.expansion
        for li, n_blocks in enumerate(layers):
            planes = 64 * (2 ** li)
            for b in range(n_blocks):
                stride = 2 if (b == 0 and li > 0) else 1
                needs_ds = b == 0 and (stride != 1 or inplanes != planes * exp)
                blocks.append(block_cls(
                    inplanes, planes, groups, reduction, stride, needs_ds,
                    1 if li == 0 else downsample_kernel_size,
                    0 if li == 0 else downsample_padding))
                inplanes = planes * exp
        self.blocks = nn.ModuleList(blocks)
        self.n_out_filters = 512 * exp

    def conv_info(self):
        raise NotImplementedError(
            "receptive-field math is not wired for SENet backbones")

    def reset_parameters(self, generator=None):
        """The JAX package's initialization: conv kernels from
        ``conv_kernel_init``, conv biases (the SE gates') 0, norm scale 1
        and bias 0."""
        for mod in self.modules():
            if isinstance(mod, nn.Conv1d):
                conv_kernel_init(mod.weight, generator)
                if mod.bias is not None:
                    nn.init.zeros_(mod.bias)
            elif isinstance(mod, BatchStatNorm):
                nn.init.ones_(mod.weight)
                nn.init.zeros_(mod.bias)
        return self

    def forward(self, x, deterministic=False, generator=None, groups=1):
        """(N, C, 224) -> (N, n_out_filters)."""
        h = x
        for conv, norm in zip(self.convs, self.norms):
            h = F.relu(norm(conv(h), groups))
        # torch's ceil_mode pool: pad the right so a partial window counts
        pad = (2 - (h.shape[2] - 3) % 2) % 2
        if pad:
            h = F.pad(h, (0, pad), value=float("-inf"))
        h = max_pool1d(h, 3, 2)
        for block in self.blocks:
            h = block(h, groups)
        h = global_avg_pool_flatten(h, window=7)
        if self.dropout_p and not deterministic:
            h = dropout(h, self.dropout_p, generator)
        return h


def _make(block_cls, layers, groups, reduction, dropout_p=None, **kw):
    """The named network's constructor, ``ctor(in_channels=1)``: a
    ``functools.partial`` of ``SENet1D``."""
    resnet_stem = dict(inplanes=64, input_3x3=False,
                       downsample_kernel_size=1, downsample_padding=0)
    return functools.partial(SENet1D, block_cls, layers, groups, reduction,
                             dropout_p, **(kw or resnet_stem))


senet18 = _make(SEBasicBlock, (2, 2, 2, 2), 64, 4, 0.2, inplanes=128)
senet154 = _make(SEBottleneck, (3, 8, 36, 3), 64, 16, 0.2, inplanes=128)
se_resnet18 = _make(SEBasicBlock, (2, 2, 2, 2), 1, 4)
se_resnet50 = _make(SEResNetBottleneck, (3, 4, 6, 3), 1, 16)
se_resnet101 = _make(SEResNetBottleneck, (3, 4, 23, 3), 1, 16)
se_resnet152 = _make(SEResNetBottleneck, (3, 8, 36, 3), 1, 16)
se_resnext50_32x4d = _make(SEResNeXtBottleneck, (3, 4, 6, 3), 32, 16)
se_resnext101_32x4d = _make(SEResNeXtBottleneck, (3, 4, 23, 3), 32, 16)
