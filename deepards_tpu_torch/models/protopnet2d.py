"""ProtoPNet-2D over breath images.

Counterpart of ``deepards_tpu/models/protopnet2d.py`` (reference:
deepards/models/protopnet2d/model.py): the 2D backbone's
``forward_no_pool`` map -> the 1x1 add-on stack of the 1D network (over
the H'*W' positions) -> the squared L2 distance of every position to each
(proto_channels,) prototype, a matmul as in 1D -> the minimum over the
positions -> log similarity -> the bias-free class-identity Linear.

Layouts follow the JAX package where they are read outside the model:
``l2_distances`` gives (N, H'*W', P), positions row-major over (H', W'),
and ``push_forward`` the latent patches as (N, H', W', C), so the push's
flat positions are those of the JAX trainer.  ``prototype_vectors`` is
(P, proto_channels), as flax holds it.
"""
import torch
import torch.nn.functional as F
from torch import nn

from deepards_tpu_torch.models.layers import promoted_linear
from deepards_tpu_torch.models.protopnet1d import (
    AddOnLayers,
    prototype_class_identity,
)


class PPNet2D(nn.Module):
    """``forward(x (N, C, H, W)) -> (logits (N, 2), min distances (N,
    P))``."""

    def __init__(self, breath_block, num_prototypes=20, proto_channels=128,
                 num_classes=2, prototype_activation_function="log",
                 incorrect_strength=-0.5, epsilon=1e-4):
        super().__init__()
        self.breath_block = breath_block
        self.num_prototypes = num_prototypes
        self.proto_channels = proto_channels
        self.num_classes = num_classes
        self.prototype_activation_function = prototype_activation_function
        self.incorrect_strength = incorrect_strength
        self.epsilon = epsilon
        self.prototype_vectors = nn.Parameter(torch.rand(self.prototype_shape))
        self.add_on_layers = AddOnLayers(breath_block.n_out_filters,
                                         proto_channels)
        self.last_layer = nn.Linear(num_prototypes, num_classes, bias=False)

    @property
    def prototype_shape(self):
        return (self.num_prototypes, self.proto_channels)

    @property
    def max_dist(self):
        return self.proto_channels

    def class_identity(self):
        return prototype_class_identity(self.num_prototypes,
                                        self.num_classes)

    def class_identity_windows(self):
        """The identity of the last layer's inputs: one image's P
        similarities."""
        return self.class_identity()

    def reset_parameters(self, generator=None):
        """Backbone init, prototypes uniform in [0, 1), the add-ons, the
        class-identity last layer (1 for a prototype's own class,
        ``incorrect_strength`` for the others)."""
        self.breath_block.reset_parameters(generator)
        ident = self.class_identity()
        weights = 1.0 * ident + self.incorrect_strength * (1 - ident)
        with torch.no_grad():
            self.prototype_vectors.copy_(
                torch.rand(self.prototype_shape, generator=generator))
            self.last_layer.weight.copy_(torch.from_numpy(weights.T.copy()))
        self.add_on_layers.reset_parameters(generator)
        return self

    def conv_features(self, x, deterministic=False, generator=None):
        """(N, C, H, W) -> (N, proto_channels, H', W') latent patches."""
        fmap = self.breath_block.forward_no_pool(x, deterministic, generator)
        return self.add_on_layers(fmap.flatten(2)).reshape(
            fmap.shape[0], -1, *fmap.shape[2:])

    def l2_distances(self, feats):
        """(N, C, H', W') patches vs the prototypes -> (N, H'*W', P)
        squared distances, ||x||^2 + ||p||^2 - 2<x, p>, clamped at 0; the
        cross term accumulates in float32 at least, as the JAX einsum's
        ``preferred_element_type``."""
        flat = feats.flatten(2).transpose(1, 2)  # (N, H'*W', C)
        protos = self.prototype_vectors.to(feats.dtype)
        acc = torch.promote_types(feats.dtype, torch.float32)
        x2 = flat.square().sum(dim=-1, keepdim=True)
        p2 = protos.square().sum(dim=-1)
        xp = torch.matmul(flat.to(acc), protos.t().to(acc))
        return F.relu(x2 + p2[None, None, :] - 2 * xp)

    def distance_to_similarity(self, distances):
        if self.prototype_activation_function == "log":
            return torch.log((distances + 1) / (distances + self.epsilon))
        return -distances

    def forward(self, x, deterministic=False, generator=None, metadata=None):
        d = self.l2_distances(self.conv_features(x, deterministic,
                                                 generator))
        min_d = d.min(dim=1).values  # (N, P)
        sim = self.distance_to_similarity(min_d)
        return promoted_linear(sim, self.last_layer), min_d

    def push_forward(self, x, deterministic=True, generator=None):
        """Latent patches (N, H', W', C) and distances (N, H'*W', P) for
        the prototype push."""
        feats = self.conv_features(x, deterministic, generator)
        return feats.permute(0, 2, 3, 1), self.l2_distances(feats)


def construct_ppnet_2d(base_architecture, n_prototypes=10, num_classes=2,
                       incorrect_strength=-0.5):
    """``n_prototypes`` per class."""
    return PPNet2D(base_architecture,
                   num_prototypes=n_prototypes * num_classes,
                   num_classes=num_classes,
                   incorrect_strength=incorrect_strength)
