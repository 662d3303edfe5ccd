"""Composite networks: CNN backbone + classification head.

Counterpart of ``deepards_tpu/models/heads.py``.  Every head folds
(batch, windows) into one (B*S)-row batch and runs the backbone once.
With ``metadata_features`` > 0 a head concatenates the window's (S,
metadata_features) metadata, flattened, to its features before the
Dense, as the JAX heads do; with 0 it ignores metadata.
"""
import math

import torch
import torch.nn.functional as F
from torch import nn


def _window_features(breath_block, x, bn_scope, deterministic, generator):
    """(B, S, C, L) -> (B, S, F) window features.

    bn_scope='batch': normalization statistics span all B*S windows.
    bn_scope='sequence': each sample's S windows have statistics of their
    own, as one grouped reduction over the same (B*S)-row backbone call.
    """
    b, s, c, length = x.shape
    groups = b if bn_scope == "sequence" else 1
    feats = breath_block(
        x.reshape(b * s, c, length), deterministic, generator, groups)
    return feats.reshape(b, s, -1)


class CNNLinearNetwork(nn.Module):
    """Flatten all window features (and the metadata) -> one Linear ->
    (B, 2) logits."""

    def __init__(self, breath_block, n_sub_batches, bn_scope="batch",
                 metadata_features=0):
        super().__init__()
        if bn_scope not in ("batch", "sequence"):
            raise ValueError("bn_scope must be 'batch' or 'sequence'")
        self.breath_block = breath_block
        self.bn_scope = bn_scope
        self.metadata_features = metadata_features
        self.head = nn.Linear(
            n_sub_batches * (breath_block.n_out_filters + metadata_features),
            2)

    def reset_parameters(self, generator=None):
        """Backbone init, then the head: kernel normal(0, 1/sqrt(fan_in))
        (the scale of flax's default lecun_normal, untruncated), bias 0."""
        self.breath_block.reset_parameters(generator)
        w = self.head.weight
        with torch.no_grad():
            w.copy_(torch.randn(w.shape, generator=generator)
                    / math.sqrt(w.shape[1]))
            self.head.bias.zero_()
        return self

    def forward(self, x, deterministic=False, generator=None, metadata=None):
        feats = _window_features(
            self.breath_block, x, self.bn_scope, deterministic, generator)
        flat = feats.reshape(feats.shape[0], -1)
        if not self.metadata_features:
            return self.head(flat)
        # float32 metadata beside bfloat16 features: the Dense runs in the
        # promoted type, as flax's Dense does for mixed inputs
        meta = metadata.reshape(flat.shape[0], -1)
        dtype = torch.promote_types(flat.dtype, meta.dtype)
        flat = torch.cat([flat.to(dtype), meta.to(dtype)], dim=-1)
        return F.linear(flat, self.head.weight.to(dtype),
                        self.head.bias.to(dtype))
