"""ResNet 1D backbone family (resnet18/34/50/101/152).

Counterpart of ``deepards_tpu/models/resnet1d.py``: a stem conv (or a
3-wide then a 7-wide conv with ``double_conv_first``), a max or average
pool (``first_pool_type``), four stages of basic or bottleneck blocks that
double the planes and halve the length, batch-statistic normalization
throughout and no dropout.  Input and output layout is (N, C, L); the
final 7-wide pool needs L = 224 (224 -> 112 -> 56 -> 56/28/14/7).

The stem and every block hold their convs and norms in lists indexed as
the JAX package creates them (``Conv1d_k`` is ``convs[k]``), so a block's
downsample is its last conv and norm: index 2 in ``BasicBlock``, 3 in
``Bottleneck``.  Every call takes ``groups`` (see ``BatchStatNorm``).
"""
import torch.nn.functional as F
from torch import nn

from deepards_tpu_torch.models.layers import (
    BatchStatNorm,
    avg_pool1d,
    conv_kernel_init,
    global_avg_pool_flatten,
    max_pool1d,
)


def _conv(cin, cout, kernel, stride=1, padding=0):
    return nn.Conv1d(cin, cout, kernel, stride=stride, padding=padding,
                     bias=False)


class BasicBlock(nn.Module):
    expansion = 1

    def __init__(self, inplanes, planes, stride=1, downsample=False):
        super().__init__()
        convs = [_conv(inplanes, planes, 3, stride, 1),
                 _conv(planes, planes, 3, 1, 1)]
        if downsample:
            convs.append(_conv(inplanes, planes, 1, stride))
        self.convs = nn.ModuleList(convs)
        self.norms = nn.ModuleList(BatchStatNorm(planes) for _ in convs)
        self.downsample = downsample

    def forward(self, x, groups=1):
        h = F.relu(self.norms[0](self.convs[0](x), groups))
        h = self.norms[1](self.convs[1](h), groups)
        identity = x
        if self.downsample:
            identity = self.norms[2](self.convs[2](x), groups)
        return F.relu(h + identity)


class Bottleneck(nn.Module):
    expansion = 4

    def __init__(self, inplanes, planes, stride=1, downsample=False):
        super().__init__()
        out = planes * self.expansion
        convs = [_conv(inplanes, planes, 1),
                 _conv(planes, planes, 3, stride, 1),
                 _conv(planes, out, 1)]
        widths = [planes, planes, out]
        if downsample:
            convs.append(_conv(inplanes, out, 1, stride))
            widths.append(out)
        self.convs = nn.ModuleList(convs)
        self.norms = nn.ModuleList(BatchStatNorm(w) for w in widths)
        self.downsample = downsample

    def forward(self, x, groups=1):
        h = F.relu(self.norms[0](self.convs[0](x), groups))
        h = F.relu(self.norms[1](self.convs[1](h), groups))
        h = self.norms[2](self.convs[2](h), groups)
        identity = x
        if self.downsample:
            identity = self.norms[3](self.convs[3](x), groups)
        return F.relu(h + identity)


class ResNet1D(nn.Module):
    def __init__(self, block_cls=BasicBlock, layers=(2, 2, 2, 2),
                 initial_planes=64, first_pool_type="max",
                 double_conv_first=False, in_channels=1):
        super().__init__()
        if first_pool_type not in ("max", "avg"):
            raise ValueError("first_pool_type must be 'max' or 'avg'")
        self.first_pool_type = first_pool_type
        self.in_channels = in_channels
        planes = initial_planes
        if double_conv_first:
            convs = [_conv(in_channels, planes, 3, 1, 1),
                     _conv(planes, planes, 7, 2, 3)]
        else:
            convs = [_conv(in_channels, planes, 7, 2, 3)]
        self.convs = nn.ModuleList(convs)
        self.norms = nn.ModuleList(BatchStatNorm(planes) for _ in convs)
        blocks = []
        inplanes = initial_planes
        exp = block_cls.expansion
        for li, n_blocks in enumerate(layers):
            planes = initial_planes * (2 ** li)
            for b in range(n_blocks):
                stride = 2 if (b == 0 and li > 0) else 1
                # resnet50+ downsample at stride 1 too: 64 -> 256 channels
                downsample = b == 0 and (stride != 1
                                         or inplanes != planes * exp)
                blocks.append(block_cls(inplanes, planes, stride, downsample))
                inplanes = planes * exp
        self.blocks = nn.ModuleList(blocks)
        self.n_out_filters = initial_planes * 8 * exp

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

    def features(self, x, groups=1):
        h = x
        for conv, norm in zip(self.convs, self.norms):
            h = norm(conv(h), groups)
        h = F.relu(h)
        if self.first_pool_type == "max":
            h = max_pool1d(h, 3, 2, padding=1)
        else:
            h = avg_pool1d(h, 3, 2, padding=1)
        for block in self.blocks:
            h = block(h, groups)
        return h

    def forward(self, x, deterministic=False, generator=None, groups=1):
        """(N, C, 224) -> (N, n_out_filters); ResNet has no dropout, so
        ``deterministic`` and ``generator`` change nothing."""
        return global_avg_pool_flatten(self.features(x, groups), window=7)

    def forward_no_pool(self, x, deterministic=False, generator=None,
                        groups=1):
        """Pre-pool feature map (N, C', L') for GradCAM / ProtoPNet."""
        return self.features(x, groups)


def _make(block, layers):
    def ctor(initial_planes=64, first_pool_type="max",
             double_conv_first=False, in_channels=1):
        return ResNet1D(block, layers, initial_planes, first_pool_type,
                        bool(double_conv_first), in_channels)

    return ctor


resnet18 = _make(BasicBlock, (2, 2, 2, 2))
resnet34 = _make(BasicBlock, (3, 4, 6, 3))
resnet50 = _make(Bottleneck, (3, 4, 6, 3))
resnet101 = _make(Bottleneck, (3, 4, 23, 3))
resnet152 = _make(Bottleneck, (3, 8, 36, 3))
