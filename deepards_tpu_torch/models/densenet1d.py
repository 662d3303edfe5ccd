"""DenseNet-BC 1D backbone family (densenet18/121/161/169/201).

Counterpart of ``deepards_tpu/models/densenet1d.py``: growth-rate dense
blocks with 1x1 bottlenecks, transitions that halve the channels and the
length, batch-statistic normalization throughout, and dropout 0.2 after
each dense layer.  Input and output layout is (N, C, L).

``in_channels`` is the cache's C: 1 (flow), or more with the FFT
channels of ``--with-fft``/``--only-fft``.  Every call takes ``groups``:
the rows split into that many equal groups, each with its own
normalization statistics (see ``BatchStatNorm``).
Dropout draws from the ``generator`` it is given.
"""
import torch
import torch.nn.functional as F
from torch import nn

from deepards_tpu_torch.models.layers import (
    BatchStatNorm,
    avg_pool1d,
    conv_kernel_init,
    dropout,
    global_avg_pool_flatten,
    max_pool1d,
)


class DenseLayer(nn.Module):
    def __init__(self, in_features, growth_rate, bn_size, drop_rate):
        super().__init__()
        self.drop_rate = drop_rate
        self.norm1 = BatchStatNorm(in_features)
        self.conv1 = nn.Conv1d(
            in_features, bn_size * growth_rate, 1, bias=False)
        self.norm2 = BatchStatNorm(bn_size * growth_rate)
        self.conv2 = nn.Conv1d(
            bn_size * growth_rate, growth_rate, 3, padding=1, bias=False)

    def forward(self, x, deterministic=False, generator=None, groups=1):
        h = F.relu(self.norm1(x, groups))
        h = self.conv1(h)
        h = F.relu(self.norm2(h, groups))
        h = self.conv2(h)
        if self.drop_rate > 0 and not deterministic:
            h = dropout(h, self.drop_rate, generator)
        return torch.cat([x, h], dim=1)


class Transition(nn.Module):
    def __init__(self, in_features, out_features):
        super().__init__()
        self.norm = BatchStatNorm(in_features)
        self.conv = nn.Conv1d(in_features, out_features, 1, bias=False)

    def forward(self, x, groups=1):
        h = F.relu(self.norm(x, groups))
        h = self.conv(h)
        return avg_pool1d(h, 2, 2)


class DenseNet1D(nn.Module):
    def __init__(self, growth_rate=32, block_config=(2, 2, 2, 2),
                 num_init_features=64, bn_size=4, drop_rate=0.2,
                 in_channels=1):
        super().__init__()
        self.in_channels = in_channels
        self.block_config = tuple(block_config)
        self.conv0 = nn.Conv1d(
            in_channels, num_init_features, 7, stride=2, padding=3,
            bias=False)
        self.norm0 = BatchStatNorm(num_init_features)
        self.dense_layers = nn.ModuleList()
        self.transitions = nn.ModuleList()
        n = num_init_features
        for i, layers in enumerate(self.block_config):
            for _ in range(layers):
                self.dense_layers.append(
                    DenseLayer(n, growth_rate, bn_size, drop_rate))
                n += growth_rate
            if i != len(self.block_config) - 1:
                self.transitions.append(Transition(n, n // 2))
                n = n // 2
        self.norm5 = BatchStatNorm(n)
        self.n_out_filters = n

    def conv_info(self):
        """Kernel sizes, strides and paddings of every conv and pool in
        order, for ProtoPNet's receptive-field arithmetic: the stem's conv
        and max pool, each dense layer's two convs, each transition's conv
        and average pool (reference: deepards/models/densenet.py:169-177)."""
        ks, ss, ps = [7, 3], [2, 2], [3, 1]
        for i, layers in enumerate(self.block_config):
            for _ in range(layers):
                ks += [1, 3]
                ss += [1, 1]
                ps += [0, 1]
            if i != len(self.block_config) - 1:
                ks += [1, 2]
                ss += [1, 2]
                ps += [0, 0]
        return ks, ss, ps

    def reset_parameters(self, generator=None):
        """The JAX package's initialization: conv kernels from
        ``conv_kernel_init``, norm scale 1 and bias 0."""
        for mod in self.modules():
            if isinstance(mod, nn.Conv1d):
                conv_kernel_init(mod.weight, generator)
            elif isinstance(mod, BatchStatNorm):
                nn.init.ones_(mod.weight)
                nn.init.zeros_(mod.bias)
        return self

    def features(self, x, deterministic=False, generator=None, groups=1):
        h = self.conv0(x)
        h = F.relu(self.norm0(h, groups))
        h = max_pool1d(h, 3, 2, padding=1)
        layer = 0
        for i, layers in enumerate(self.block_config):
            for _ in range(layers):
                h = self.dense_layers[layer](
                    h, deterministic, generator, groups)
                layer += 1
            if i != len(self.block_config) - 1:
                h = self.transitions[i](h, groups)
        return self.norm5(h, groups)

    def forward(self, x, deterministic=False, generator=None, groups=1):
        h = F.relu(self.features(x, deterministic, generator, groups))
        return global_avg_pool_flatten(h, window=7)

    def forward_no_pool(self, x, deterministic=False, generator=None,
                        groups=1):
        """Pre-pool feature map (N, C', L') for GradCAM / ProtoPNet."""
        return F.relu(self.features(x, deterministic, generator, groups))


def _make(growth_rate, block_config, num_init_features):
    def ctor(**kwargs):
        return DenseNet1D(
            growth_rate=growth_rate,
            block_config=block_config,
            num_init_features=num_init_features,
            **kwargs,
        )

    return ctor


densenet18 = _make(32, (2, 2, 2, 2), 64)
densenet121 = _make(32, (6, 12, 24, 16), 64)
densenet161 = _make(48, (6, 12, 36, 24), 96)
densenet169 = _make(32, (6, 12, 32, 32), 64)
densenet201 = _make(32, (6, 12, 48, 32), 64)
