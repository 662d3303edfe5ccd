"""UNet 1D: the encoder as a backbone, and the full network.

Counterpart of ``deepards_tpu/models/unet1d.py``.  ``double_convs[k]`` is
flax's ``DoubleConv_k`` (two 3-wide convs with a bias, each followed by
ReLU), ``out_conv`` the full network's 1x1 ``Conv1d_0``.  UNet has no
normalization and no dropout; every call takes ``groups`` all the same.

``UNet1DEncoder`` (the registry's ``unet``) runs the down path and
flattens its (N, 512, L / 8) map length-major, as the JAX package's (N,
L, C) reshape does: 28 x 512 = 14,336 features a window at L = 224.  Its
``n_out_filters`` is that width, which the heads size their Linear by;
the JAX encoder reports 512, and its heads, which flax sizes from their
input, read 14,336 all the same.

``linear_upsample`` doubles the length as ``jax.image.resize(...,
"linear")`` does: half-pixel centres, an edge sample repeating the edge
(torch's ``align_corners=False``), although the JAX docstring names
``align_corners=True``.
"""
import torch
import torch.nn.functional as F
from torch import nn

from deepards_tpu_torch.models.layers import conv_kernel_init, max_pool1d

SEQ_LEN = 224


class DoubleConv(nn.Module):
    def __init__(self, cin, cout):
        super().__init__()
        self.convs = nn.ModuleList([nn.Conv1d(cin, cout, 3, padding=1),
                                    nn.Conv1d(cout, cout, 3, padding=1)])

    def forward(self, x):
        return F.relu(self.convs[1](F.relu(self.convs[0](x))))


def linear_upsample(x, factor=2):
    """(N, C, L) -> (N, C, factor * L), linear at half-pixel centres."""
    return F.interpolate(x, scale_factor=factor, mode="linear",
                         align_corners=False)


def _reset_convs(module, generator):
    """Conv kernels from ``conv_kernel_init``, biases 0."""
    for mod in module.modules():
        if isinstance(mod, nn.Conv1d):
            conv_kernel_init(mod.weight, generator)
            nn.init.zeros_(mod.bias)
    return module


DOWN = (64, 128, 256, 512)


class UNet1DEncoder(nn.Module):
    """The down path, flattened: (N, C, L) -> (N, 512 * L / 8)."""

    def __init__(self, in_channels=1, seq_len=SEQ_LEN):
        super().__init__()
        self.in_channels = in_channels
        ins = (in_channels,) + DOWN[:-1]
        self.double_convs = nn.ModuleList(
            DoubleConv(i, o) for i, o in zip(ins, DOWN))
        self.n_out_filters = DOWN[-1] * (seq_len // 8)

    def reset_parameters(self, generator=None):
        return _reset_convs(self, generator)

    def forward(self, x, deterministic=False, generator=None, groups=1):
        h = x
        for k, double_conv in enumerate(self.double_convs):
            if k:
                h = max_pool1d(h, 2, 2)
            h = double_conv(h)
        return h.transpose(1, 2).reshape(h.shape[0], -1)


class UNet1D(nn.Module):
    """Down path, then three linear upsamples, each joined to the down
    map of its length and through a DoubleConv, then the 1x1
    ``out_conv``: (N, C, L) -> (N, n_class, L)."""

    def __init__(self, n_class=1, in_channels=1):
        super().__init__()
        self.in_channels = in_channels
        ins = (in_channels,) + DOWN[:-1]
        ups = [(DOWN[3] + DOWN[2], DOWN[2]), (DOWN[2] + DOWN[1], DOWN[1]),
               (DOWN[1] + DOWN[0], DOWN[0])]
        self.double_convs = nn.ModuleList(
            [DoubleConv(i, o) for i, o in zip(ins, DOWN)]
            + [DoubleConv(i, o) for i, o in ups])
        self.out_conv = nn.Conv1d(DOWN[0], n_class, 1)

    def reset_parameters(self, generator=None):
        return _reset_convs(self, generator)

    def forward(self, x, deterministic=False, generator=None, groups=1):
        skips = []
        h = x
        for k in range(4):
            if k:
                h = max_pool1d(h, 2, 2)
            h = self.double_convs[k](h)
            skips.append(h)
        for k, skip in zip(range(4, 7), reversed(skips[:3])):
            h = torch.cat([linear_upsample(h), skip], dim=1)
            h = self.double_convs[k](h)
        return self.out_conv(h)
