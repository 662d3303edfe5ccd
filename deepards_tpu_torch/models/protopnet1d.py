"""ProtoPNet-1D: the case-based interpretable network.

Counterpart of ``deepards_tpu/models/protopnet1d.py``: the backbone's
``forward_no_pool`` feature map -> a 1x1 bottleneck add-on stack -> the
squared L2 distance of every latent patch to each learned prototype ->
the minimum over positions -> log similarity -> a bias-free Linear set to
the prototypes' class identity.  All B*S windows go through the backbone
as one batch.

Layouts follow the JAX package where they are read outside the model:
``l2_distances`` gives (N, L'', P) and ``push_forward`` the latent patches
as (B, S, L', C), so the push's flat positions and the (B, S*P) minimum
distances are ordered as there.  The distance of prototype kernels K = 1
is a matmul, of K > 1 a conv1d (the JAX package's einsum and XLA conv;
no Pallas kernel).  Under a bfloat16 forward the dtypes follow the JAX
package's: ``x**2`` and ``p**2`` are summed in the compute dtype, the
cross term accumulates in float32 (``preferred_element_type``), so the
distance and what follows it are float32.
"""
import math

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from deepards_tpu_torch.models.layers import (
    promoted_linear,
    truncated_normal_,
)


def compute_layer_rf_info(layer_filter_size, layer_stride, layer_padding,
                          previous_layer_rf_info):
    """One conv/pool layer's [n_out, jump, rf_size, start] update
    (reference: deepards/models/protopnet1d/model.py:11-46)."""
    n_in, j_in, r_in, start_in = previous_layer_rf_info
    if layer_padding == "SAME":
        n_out = math.ceil(float(n_in) / float(layer_stride))
        pad = max((n_out - 1) * layer_stride + layer_filter_size - n_in, 0)
    elif layer_padding == "VALID":
        n_out = math.ceil(
            float(n_in - layer_filter_size + 1) / float(layer_stride))
        pad = 0
    else:
        pad = layer_padding * 2
        n_out = math.floor(
            (n_in - layer_filter_size + pad) / layer_stride) + 1
    p_l = pad // 2
    j_out = j_in * layer_stride
    r_out = r_in + (layer_filter_size - 1) * j_in
    start_out = start_in + ((layer_filter_size - 1) / 2 - p_l) * j_in
    return [n_out, j_out, r_out, start_out]


def compute_proto_layer_rf_info(seq_len, layer_filter_sizes, layer_strides,
                                layer_paddings, prototype_kernel_size):
    """(reference: deepards/models/protopnet1d/model.py:81-110)"""
    rf_info = [seq_len, 1, 1, 0.5]
    for k, s, p in zip(layer_filter_sizes, layer_strides, layer_paddings):
        rf_info = compute_layer_rf_info(k, s, p, rf_info)
    return compute_layer_rf_info(prototype_kernel_size, 1, "VALID", rf_info)


def compute_rf_boundaries(spatial_index, rf_info, seq_len=224):
    """Input-space [lo, hi) window covered by a proto-layer position."""
    _, jump, rf, start = rf_info
    center = start + spatial_index * jump
    lo = max(int(center - rf / 2), 0)
    hi = min(int(center + rf / 2), seq_len)
    return lo, hi


def _kaiming_normal_(conv, generator=None):
    """flax's ``kaiming_normal``: a normal truncated at +-2 standard
    deviations with variance 2 / fan_in; bias 0."""
    fan_in = conv.weight.shape[1] * conv.weight.shape[2]
    truncated_normal_(conv.weight, math.sqrt(2.0 / fan_in), generator)
    with torch.no_grad():
        conv.bias.zero_()


class AddOnLayers(nn.Module):
    """1x1 convs halving the channels down to the prototype depth, in
    pairs: ReLU between, ReLU after a pair above the prototype depth and a
    sigmoid after the last (reference: model.py:158-185)."""

    def __init__(self, in_channels, proto_channels, fmap_channels=None):
        super().__init__()
        self.convs = nn.ModuleList()
        self.relu_after = []  # per pair: ReLU, else the closing sigmoid
        # the widths halve from the backbone's n_out_filters, while the
        # first conv reads the map's own channels where they differ (VGG:
        # 512 * 7 and 512), as flax sizes a Conv from its input
        current_in, first = in_channels, True
        width = fmap_channels or in_channels
        while current_in > proto_channels or first:
            first = False
            current_out = max(proto_channels, current_in // 2)
            self.convs.append(nn.Conv1d(width, current_out, 1))
            self.convs.append(nn.Conv1d(current_out, current_out, 1))
            self.relu_after.append(current_out > proto_channels)
            width, current_in = current_out, current_in // 2

    def reset_parameters(self, generator=None):
        for conv in self.convs:
            _kaiming_normal_(conv, generator)
        return self

    def forward(self, x):
        for k, relu_after in enumerate(self.relu_after):
            x = F.relu(self.convs[2 * k](x))
            x = self.convs[2 * k + 1](x)
            x = F.relu(x) if relu_after else torch.sigmoid(x)
        return x


def prototype_class_identity(num_prototypes, num_classes):
    """One-hot (P, num_classes) class assignment, equal split
    (reference: model.py:135-141)."""
    per_class = num_prototypes // num_classes
    ident = np.zeros((num_prototypes, num_classes), np.float32)
    for j in range(num_prototypes):
        ident[j, j // per_class] = 1.0
    return ident


class PPNet(nn.Module):
    """``forward(x (B, S, C, L)) -> (logits (B, 2), min distances (B,
    S*P))``; ``prototype_vectors`` (P, proto_channels, proto_kernel)."""

    def __init__(self, breath_block, sub_batch_size=20, num_prototypes=20,
                 proto_channels=128, proto_kernel=1, num_classes=2,
                 prototype_activation_function="log",
                 incorrect_strength=-0.5, average_linear=False,
                 epsilon=1e-4):
        super().__init__()
        self.breath_block = breath_block
        self.sub_batch_size = sub_batch_size
        self.num_prototypes = num_prototypes
        self.proto_channels = proto_channels
        self.proto_kernel = proto_kernel
        self.num_classes = num_classes
        self.prototype_activation_function = prototype_activation_function
        self.incorrect_strength = incorrect_strength
        self.average_linear = average_linear
        self.epsilon = epsilon
        self.prototype_vectors = nn.Parameter(torch.rand(self.prototype_shape))
        self.add_on_layers = AddOnLayers(
            breath_block.n_out_filters, proto_channels,
            getattr(breath_block, "fmap_channels", None))
        ident_rows = num_prototypes * (1 if average_linear
                                       else sub_batch_size)
        self.last_layer = nn.Linear(ident_rows, num_classes, bias=False)

    @property
    def prototype_shape(self):
        return (self.num_prototypes, self.proto_channels, self.proto_kernel)

    @property
    def max_dist(self):
        return self.proto_channels * self.proto_kernel

    def proto_layer_rf_info(self, seq_len=224):
        ks, ss, ps = self.breath_block.conv_info()
        return compute_proto_layer_rf_info(seq_len, ks, ss, ps,
                                           self.proto_kernel)

    def class_identity(self):
        return prototype_class_identity(self.num_prototypes,
                                        self.num_classes)

    def class_identity_windows(self):
        """The identity tiled once per window, as the (B, S*P) minimum
        distances are laid out (reference: model.py:143)."""
        return np.tile(self.class_identity(), (self.sub_batch_size, 1))

    def last_layer_init(self):
        """(in, num_classes) class-identity weights: 1 for a prototype's
        own class, ``incorrect_strength`` for the others, tiled S times
        unless ``average_linear`` (reference: model.py:319-333)."""
        ident = self.class_identity()
        if not self.average_linear:
            ident = np.tile(ident, (self.sub_batch_size, 1))
        return 1.0 * ident + self.incorrect_strength * (1 - ident)

    def reset_parameters(self, generator=None):
        """Backbone init, prototypes uniform in [0, 1), the add-ons
        (``_kaiming_normal_``), the class-identity last layer."""
        self.breath_block.reset_parameters(generator)
        with torch.no_grad():
            self.prototype_vectors.copy_(
                torch.rand(self.prototype_shape, generator=generator))
            self.last_layer.weight.copy_(
                torch.from_numpy(self.last_layer_init().T.copy()))
        self.add_on_layers.reset_parameters(generator)
        return self

    def conv_features(self, x, deterministic=False, generator=None):
        """(N, C, L) -> (N, proto_channels, L') latent patches."""
        fmap = self.breath_block.forward_no_pool(x, deterministic, generator)
        return self.add_on_layers(fmap)

    def l2_distances(self, feats):
        """(N, C, L') patches vs the prototypes -> (N, L'', P) squared
        distances, ||x||^2 + ||p||^2 - 2<x, p>, clamped at 0
        (reference: model.py:217-242)."""
        protos = self.prototype_vectors.to(feats.dtype)
        p, _, k = protos.shape
        acc = torch.promote_types(feats.dtype, torch.float32)
        if k == 1:
            pv = protos[:, :, 0]  # (P, C)
            x2 = feats.square().sum(dim=1)[:, :, None]  # (N, L', 1)
            p2 = pv.square().sum(dim=1)  # (P,)
            # products of the compute dtype are exact in float32: the JAX
            # einsum's preferred_element_type=float32
            xp = torch.matmul(feats.transpose(1, 2).to(acc), pv.t().to(acc))
            d = x2 + p2[None, None, :] - 2 * xp
        else:
            x2 = F.conv1d(feats.square(), torch.ones_like(protos))
            xp = F.conv1d(feats, protos)
            p2 = protos.square().sum(dim=(1, 2))
            d = (x2 - 2 * xp + p2[None, :, None]).transpose(1, 2)
        return F.relu(d)

    def distance_to_similarity(self, distances):
        if self.prototype_activation_function == "log":
            return torch.log((distances + 1) / (distances + self.epsilon))
        if self.prototype_activation_function == "linear":
            return -distances
        raise ValueError("unknown prototype activation")

    def forward(self, x, deterministic=False, generator=None, metadata=None):
        b, s, c, length = x.shape
        feats = self.conv_features(x.reshape(b * s, c, length),
                                   deterministic, generator)
        d = self.l2_distances(feats)  # (B*S, L'', P)
        min_d = d.min(dim=1).values  # (B*S, P)
        sim = self.distance_to_similarity(min_d).reshape(
            b, s, self.num_prototypes)
        pooled = sim.mean(dim=1) if self.average_linear else sim.reshape(
            b, -1)
        return promoted_linear(pooled, self.last_layer), min_d.reshape(b, -1)

    def push_forward(self, x, deterministic=True, generator=None):
        """Latent patches (B, S, L', C) and distance maps (B, S, L'', P)
        for the prototype push (reference: model.py:283-296)."""
        b, s, c, length = x.shape
        feats = self.conv_features(x.reshape(b * s, c, length),
                                   deterministic, generator)
        d = self.l2_distances(feats)
        return (feats.transpose(1, 2).reshape(b, s, feats.shape[2], -1),
                d.reshape(b, s, *d.shape[1:]))


def construct_ppnet(base_architecture, sub_batch_size=20, n_prototypes=10,
                    proto_channels=128, num_classes=2, incorrect_strength=-0.5,
                    average_linear=False):
    """``n_prototypes`` per class (reference: model.py:360-384)."""
    return PPNet(base_architecture, sub_batch_size=sub_batch_size,
                 num_prototypes=n_prototypes * num_classes,
                 proto_channels=proto_channels, num_classes=num_classes,
                 incorrect_strength=incorrect_strength,
                 average_linear=average_linear)
