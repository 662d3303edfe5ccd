"""Composite networks: CNN backbone + classification or regression head.

Counterpart of ``deepards_tpu/models/heads.py``.  Every head folds
(batch, windows) into one (B*S)-row batch and runs the backbone once.
With ``metadata_features`` > 0 a head concatenates the window's (S,
metadata_features) metadata, flattened, to its features before the
Dense, as the JAX heads do; with 0 it ignores metadata.
"""
import torch
from torch import nn

from deepards_tpu_torch.models.layers import (
    SampleGroups,
    SharedDraws,
    dense_init,
    promoted_linear,
)


def _window_features(breath_block, x, bn_scope, deterministic, generator,
                     copies=1):
    """(B, S, C, L) -> (B, S, F) window features.

    bn_scope='batch': normalization statistics span all B*S windows.
    bn_scope='sequence': each sample's S windows have statistics of their
    own, as one grouped reduction over the same (B*S)-row backbone call.
    ``copies`` > 1: the B samples are that many equal stacks, each
    normalized over its own rows and dropped out with the same masks, as
    separate calls from one generator state would (``SharedDraws``).
    """
    b, s, c, length = x.shape
    groups = SampleGroups(b) if bn_scope == "sequence" else copies
    if copies > 1 and generator is not None:
        generator = SharedDraws(generator, copies)
    feats = breath_block(
        x.reshape(b * s, c, length), deterministic, generator, groups)
    return feats.reshape(b, s, -1)


def _check_bn_scope(bn_scope):
    if bn_scope not in ("batch", "sequence"):
        raise ValueError("bn_scope must be 'batch' or 'sequence'")


class CNNLinearNetwork(nn.Module):
    """Flatten all window features (and the metadata) -> one Linear ->
    (B, 2) logits."""

    def __init__(self, breath_block, n_sub_batches, bn_scope="batch",
                 metadata_features=0):
        super().__init__()
        _check_bn_scope(bn_scope)
        self.breath_block = breath_block
        self.bn_scope = bn_scope
        self.metadata_features = metadata_features
        self.head = nn.Linear(
            n_sub_batches * (breath_block.n_out_filters + metadata_features),
            2)

    def reset_parameters(self, generator=None):
        """Backbone init, then the head (``dense_init``)."""
        self.breath_block.reset_parameters(generator)
        dense_init(self.head, generator)
        return self

    def forward(self, x, deterministic=False, generator=None, metadata=None):
        feats = _window_features(
            self.breath_block, x, self.bn_scope, deterministic, generator)
        flat = feats.reshape(feats.shape[0], -1)
        if not self.metadata_features:
            return self.head(flat)
        # float32 metadata beside bfloat16 features: the Dense runs in the
        # promoted type, as flax's Dense does for mixed inputs
        return promoted_linear(_concat_flat(flat, metadata), self.head)


def _concat_flat(flat, metadata):
    """(B, K) and the (B, S, M) metadata flattened, joined in their
    promoted type, as ``jnp.concatenate`` joins them."""
    meta = metadata.reshape(flat.shape[0], -1)
    dtype = torch.promote_types(flat.dtype, meta.dtype)
    return torch.cat([flat.to(dtype), meta.to(dtype)], dim=-1)


class _WindowHead(nn.Module):
    """A backbone and a Linear ``head`` over each window's features (or
    over a pool of them): the heads below."""

    def __init__(self, breath_block, bn_scope="batch", head_in=None):
        super().__init__()
        _check_bn_scope(bn_scope)
        self.breath_block = breath_block
        self.bn_scope = bn_scope
        self.head = nn.Linear(head_in or breath_block.n_out_filters, 2)

    def reset_parameters(self, generator=None):
        self.breath_block.reset_parameters(generator)
        dense_init(self.head, generator)
        return self

    def features(self, x, deterministic, generator):
        return _window_features(
            self.breath_block, x, self.bn_scope, deterministic, generator)


class CNNSingleBreathLinearNetwork(_WindowHead):
    """Per-window logits (B, S, 2) for the per-breath target."""

    def forward(self, x, deterministic=False, generator=None, metadata=None):
        return promoted_linear(self.features(x, deterministic, generator),
                               self.head)


class CNNLinearToMean(_WindowHead):
    """The mean of the S windows' features -> Linear: (B, 2)."""

    def forward(self, x, deterministic=False, generator=None, metadata=None):
        feats = self.features(x, deterministic, generator)
        return promoted_linear(feats.mean(dim=1), self.head)


class CNNLinearComprToRF(_WindowHead):
    """The LOWER median of the S windows' features (``sort(...)[(S-1)//2]``,
    as the reference's ``torch.median``) -> Linear: (B, 2)."""

    def forward(self, x, deterministic=False, generator=None, metadata=None):
        feats = self.features(x, deterministic, generator)
        s = feats.shape[1]
        lower = torch.sort(feats, dim=1).values[:, (s - 1) // 2]
        return promoted_linear(lower, self.head)


class CNNDoubleLinearNetwork(nn.Module):
    """A Linear(F, 2) over each window, then a Linear over the S windows'
    flattened logits (and the metadata): (B, 2).  ``layers`` are flax's
    ``Dense_0`` and ``Dense_1``."""

    def __init__(self, breath_block, n_sub_batches, bn_scope="batch",
                 metadata_features=0):
        super().__init__()
        _check_bn_scope(bn_scope)
        self.breath_block = breath_block
        self.bn_scope = bn_scope
        self.metadata_features = metadata_features
        self.layers = nn.ModuleList([
            nn.Linear(breath_block.n_out_filters, 2),
            nn.Linear(n_sub_batches * (2 + metadata_features), 2)])

    def reset_parameters(self, generator=None):
        self.breath_block.reset_parameters(generator)
        for layer in self.layers:
            dense_init(layer, generator)
        return self

    def forward(self, x, deterministic=False, generator=None, metadata=None):
        feats = _window_features(
            self.breath_block, x, self.bn_scope, deterministic, generator)
        inter = promoted_linear(feats, self.layers[0])  # (B, S, 2)
        flat = inter.reshape(inter.shape[0], -1)
        if self.metadata_features:
            flat = _concat_flat(flat, metadata)
        return promoted_linear(flat, self.layers[1])


class CNNRegressor(nn.Module):
    """Flatten all window features -> one Linear -> (B, n_outputs): the
    breath-metadata pretraining regressor (9 outputs for
    ``padded_breath_by_breath_with_full_bm_target``)."""

    def __init__(self, breath_block, n_sub_batches, n_outputs=9,
                 bn_scope="batch"):
        super().__init__()
        _check_bn_scope(bn_scope)
        self.breath_block = breath_block
        self.bn_scope = bn_scope
        self.head = nn.Linear(n_sub_batches * breath_block.n_out_filters,
                              n_outputs)

    def reset_parameters(self, generator=None):
        self.breath_block.reset_parameters(generator)
        dense_init(self.head, generator)
        return self

    def forward(self, x, deterministic=False, generator=None, metadata=None):
        feats = _window_features(
            self.breath_block, x, self.bn_scope, deterministic, generator)
        return self.head(feats.reshape(feats.shape[0], -1))


class MetadataOnlyNetwork(nn.Module):
    """Linear(9, 32) -> Linear(32, 16) -> Linear(16, 2) over the mean of
    the windows' metadata, with no activation between them: the JAX
    package's (and its reference's) chain.  It has no backbone and reads
    no waveform."""

    def __init__(self):
        super().__init__()
        # over the 9 flow-time features of
        # padded_breath_by_breath_with_flow_time_features
        self.layers = nn.ModuleList([
            nn.Linear(9, 32), nn.Linear(32, 16), nn.Linear(16, 2)])

    def reset_parameters(self, generator=None):
        for layer in self.layers:
            dense_init(layer, generator)
        return self

    def forward(self, x, deterministic=False, generator=None, metadata=None):
        if metadata is None:
            raise ValueError(
                "metadata_only reads the metadata input: dataset_type "
                "padded_breath_by_breath_with_flow_time_features")
        h = metadata.mean(dim=1)  # (B, S, 9) -> (B, 9)
        for layer in self.layers:
            h = promoted_linear(h, layer)
        return h


class AutoencoderNetwork(nn.Module):
    """Reconstruction network: the full ``AutoencoderCNN`` over each
    window, (B, S, C, L) -> (B, S, C, L); its loss compares the output
    with the normalized input (reference: models/autoencoder_network.py:
    4-16)."""

    def __init__(self, breath_block):
        super().__init__()
        self.breath_block = breath_block

    def reset_parameters(self, generator=None):
        self.breath_block.reset_parameters(generator)
        return self

    def forward(self, x, deterministic=False, generator=None, metadata=None):
        b, s, c, length = x.shape
        out = self.breath_block(x.reshape(b * s, c, length), deterministic,
                                generator)
        return out.reshape(b, s, c, length)
