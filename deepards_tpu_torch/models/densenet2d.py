"""DenseNet-2D and DenseNet-2x1d backbones for breath-image datasets.

Counterpart of ``deepards_tpu/models/densenet2d.py`` (reference:
deepards/models/densenet2d.py, a torchvision-style 2D densenet with a
``block_kernel_size`` knob; deepards/models/densenet2x1d.py, the same net
with (k, 1) kernels that convolve along the image rows only).  Layout is
(N, C, H, W) in and out; batch-statistic normalization over N, H and W
throughout; dropout off by default (reference: densenet2d.py:166), unlike
the 1D family.

``CNNLinearNetwork2D`` is the backbone, a global average pool and one
Linear to (N, 2) logits (reference: torch_cnn_linear_network.py:116-125).
"""
import math

import torch
import torch.nn.functional as F
from torch import nn

from deepards_tpu_torch.models.layers import (
    BatchStatNorm,
    dense_init,
    dropout,
    promoted_linear,
    truncated_normal_,
)


def lecun_normal_(conv, generator=None):
    """flax's default conv kernel init, ``lecun_normal``: a truncated
    normal of variance 1 / fan_in."""
    fan_in = conv.weight[0].numel()
    return truncated_normal_(conv.weight, math.sqrt(1.0 / fan_in), generator)


class DenseLayer2D(nn.Module):
    def __init__(self, in_features, growth_rate, bn_size, drop_rate,
                 block_kernel):
        super().__init__()
        self.drop_rate = drop_rate
        kh, kw = block_kernel
        self.norm1 = BatchStatNorm(in_features)
        self.conv1 = nn.Conv2d(in_features, bn_size * growth_rate, 1,
                               bias=False)
        self.norm2 = BatchStatNorm(bn_size * growth_rate)
        self.conv2 = nn.Conv2d(bn_size * growth_rate, growth_rate,
                               (kh, kw), padding=(kh // 2, kw // 2),
                               bias=False)

    def forward(self, x, deterministic=False, generator=None):
        h = self.conv1(F.relu(self.norm1(x)))
        h = self.conv2(F.relu(self.norm2(h)))
        if self.drop_rate > 0 and not deterministic:
            h = dropout(h, self.drop_rate, generator)
        return torch.cat([x, h], dim=1)


class Transition2D(nn.Module):
    def __init__(self, in_features, out_features):
        super().__init__()
        self.norm = BatchStatNorm(in_features)
        self.conv = nn.Conv2d(in_features, out_features, 1, bias=False)

    def forward(self, x):
        return F.avg_pool2d(self.conv(F.relu(self.norm(x))), 2, 2)


class DenseNet2D(nn.Module):
    def __init__(self, growth_rate=32, block_config=(2, 2, 2, 2),
                 num_init_features=64, bn_size=4, drop_rate=0.0,
                 block_kernel=(3, 3), in_channels=1):
        super().__init__()
        self.in_channels = in_channels
        self.block_config = tuple(block_config)
        self.block_kernel = tuple(block_kernel)
        self.conv0 = nn.Conv2d(in_channels, num_init_features, 7, stride=2,
                               padding=3, bias=False)
        self.norm0 = BatchStatNorm(num_init_features)
        self.dense_layers = nn.ModuleList()
        self.transitions = nn.ModuleList()
        n = num_init_features
        for i, layers in enumerate(self.block_config):
            for _ in range(layers):
                self.dense_layers.append(DenseLayer2D(
                    n, growth_rate, bn_size, drop_rate, self.block_kernel))
                n += growth_rate
            if i != len(self.block_config) - 1:
                self.transitions.append(Transition2D(n, n // 2))
                n = n // 2
        self.norm5 = BatchStatNorm(n)
        self.n_out_filters = n

    def reset_parameters(self, generator=None):
        """The JAX package's initialization: conv kernels ``lecun_normal``
        (flax's default), norm scale 1 and bias 0."""
        for mod in self.modules():
            if isinstance(mod, nn.Conv2d):
                lecun_normal_(mod, generator)
            elif isinstance(mod, BatchStatNorm):
                nn.init.ones_(mod.weight)
                nn.init.zeros_(mod.bias)
        return self

    def features(self, x, deterministic=False, generator=None):
        h = F.relu(self.norm0(self.conv0(x)))
        # max pool padding is -inf, as flax's
        h = F.max_pool2d(h, 3, 2, padding=1)
        layer = 0
        for i, layers in enumerate(self.block_config):
            for _ in range(layers):
                h = self.dense_layers[layer](h, deterministic, generator)
                layer += 1
            if i != len(self.block_config) - 1:
                h = self.transitions[i](h)
        return self.norm5(h)

    def forward(self, x, deterministic=False, generator=None):
        """(N, C, H, W) -> (N, n_out_filters): the global average pool."""
        return F.relu(self.features(x, deterministic, generator)).mean(
            dim=(2, 3))

    def forward_no_pool(self, x, deterministic=False, generator=None):
        """The pre-pool feature map (N, n_out_filters, H', W')."""
        return F.relu(self.features(x, deterministic, generator))


def densenet18_2d(block_kernel_size=3, in_channels=1):
    return DenseNet2D(block_config=(2, 2, 2, 2),
                      block_kernel=(block_kernel_size, block_kernel_size),
                      in_channels=in_channels)


def densenet121_2d(block_kernel_size=3, in_channels=1):
    return DenseNet2D(block_config=(6, 12, 24, 16),
                      block_kernel=(block_kernel_size, block_kernel_size),
                      in_channels=in_channels)


def densenet18_2x1d(block_kernel_size=3, in_channels=1):
    """(k, 1) kernels: convolves along the rows only."""
    return DenseNet2D(block_config=(2, 2, 2, 2),
                      block_kernel=(block_kernel_size, 1),
                      in_channels=in_channels)


class CNNLinearNetwork2D(nn.Module):
    """The backbone's pooled features -> Linear -> (N, 2) logits."""

    def __init__(self, breath_block):
        super().__init__()
        self.breath_block = breath_block
        self.head = nn.Linear(breath_block.n_out_filters, 2)

    def reset_parameters(self, generator=None):
        self.breath_block.reset_parameters(generator)
        dense_init(self.head, generator)
        return self

    def forward(self, x, deterministic=False, generator=None, metadata=None):
        return promoted_linear(
            self.breath_block(x, deterministic, generator), self.head)
