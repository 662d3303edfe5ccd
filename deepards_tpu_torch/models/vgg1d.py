"""VGG 1D backbones (vgg11 and vgg13, with and without batch norm).

Counterpart of ``deepards_tpu/models/vgg1d.py``: 3-wide convs with a bias
(each followed by a batch-statistic norm in the ``_bn`` variants) and
ReLU, 2-wide max pools between stages, then an adaptive average pool to
length 7 (torch's windows) and a channel-major flatten to 512 * 7
features.  Input and output layout is (N, C, L); ``convs[k]`` and
``norms[k]`` are flax's ``Conv1d_k`` and ``BatchStatNorm_k``.  VGG has no
dropout.
"""
import torch.nn.functional as F
from torch import nn

from deepards_tpu_torch.models.layers import (
    BatchStatNorm,
    conv_kernel_init,
    max_pool1d,
)

CFGS = {
    "A": (64, "M", 128, "M", 256, 256, "M", 512, 512, "M", 512, 512, "M"),
    "B": (64, 64, "M", 128, 128, "M", 256, 256, "M", 512, 512, "M", 512,
          512, "M"),
}
POOLED_LENGTH = 7


class VGG1D(nn.Module):
    def __init__(self, cfg=CFGS["A"], batch_norm=True, in_channels=1):
        super().__init__()
        self.cfg = tuple(cfg)
        self.batch_norm = batch_norm
        self.in_channels = in_channels
        widths = [v for v in self.cfg if v != "M"]
        ins = [in_channels] + widths[:-1]
        self.convs = nn.ModuleList(
            nn.Conv1d(i, o, 3, padding=1) for i, o in zip(ins, widths))
        self.norms = nn.ModuleList(
            BatchStatNorm(o) for o in (widths if batch_norm else ()))
        # channels of forward_no_pool's map (ProtoPNet's add-on input)
        self.fmap_channels = widths[-1]
        self.n_out_filters = widths[-1] * POOLED_LENGTH

    def conv_info(self):
        """Kernel sizes, strides and paddings of every conv and pool in
        order, for ProtoPNet's receptive-field arithmetic."""
        ks, ss, ps = [], [], []
        for v in self.cfg:
            ks.append(2 if v == "M" else 3)
            ss.append(2 if v == "M" else 1)
            ps.append(0 if v == "M" else 1)
        return ks, ss, ps

    def reset_parameters(self, generator=None):
        """The JAX package's initialization: conv kernels from
        ``conv_kernel_init``, conv biases 0, norm scale 1 and bias 0."""
        for conv in self.convs:
            conv_kernel_init(conv.weight, generator)
            nn.init.zeros_(conv.bias)
        for norm in self.norms:
            nn.init.ones_(norm.weight)
            nn.init.zeros_(norm.bias)
        return self

    def features(self, x, groups=1):
        h, k = x, 0
        for v in self.cfg:
            if v == "M":
                h = max_pool1d(h, 2, 2)
                continue
            h = self.convs[k](h)
            if self.batch_norm:
                h = self.norms[k](h, groups)
            h = F.relu(h)
            k += 1
        return h

    def forward(self, x, deterministic=False, generator=None, groups=1):
        """(N, C, 224) -> (N, 512 * 7)."""
        h = F.adaptive_avg_pool1d(self.features(x, groups), POOLED_LENGTH)
        return h.reshape(h.shape[0], -1)

    def forward_no_pool(self, x, deterministic=False, generator=None,
                        groups=1):
        """Pre-pool feature map (N, 512, L') for GradCAM / ProtoPNet."""
        return self.features(x, groups)


def _make(cfg, batch_norm):
    def ctor(in_channels=1):
        return VGG1D(CFGS[cfg], batch_norm, in_channels)

    return ctor


vgg11 = _make("A", False)
vgg11_bn = _make("A", True)
vgg13 = _make("B", False)
vgg13_bn = _make("B", True)
