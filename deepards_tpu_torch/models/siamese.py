"""Siamese pretraining networks and the pretrained-tower classifier.

Counterpart of ``deepards_tpu/models/siamese.py``.  A twin network runs
one ``breath_block`` (the tower, shared by both inputs) over a window and
a window to compare it with, each through its own call: each side's
windows are normalized over that side's rows alone, as each flax call
normalizes its own.  An optional time layer follows (one ``LSTM``, or a
``Transformer`` of 2 blocks and 4 heads, shared by both sides), then
``|c - x|`` -> ``linear_intermediate`` (a Linear to 2 per window) ->
flatten -> ``linear_final``: (B, 2) logits.

``forward(x, compr)`` compares one pair, as the JAX network's call.  With
``negative`` it compares the anchor ``x`` with ``compr`` (the positive)
and with ``negative``, as the JAX trainer's two calls under one dropout
key, and returns both logits stacked, (2, B, 2): the anchor's tower runs
once, since two calls with the same masks give it the same features,
and the positive and the negative run as one call of two stacks, each
with its own statistics and both with the same masks
(``_window_features``' ``copies``).

``SiameseARDSClassifier`` (``siamese_pretrained``) is one tower, its time
layer (``none``, ``lstm`` or ``transformer``) and ``linear_final`` over
the S windows' flattened outputs: (B, 2) logits.  Its ``breath_block`` is
what ``--load-base-network`` splices from a siamese checkpoint.
"""
import torch
from torch import nn

from deepards_tpu_torch.models.heads import _check_bn_scope, _window_features
from deepards_tpu_torch.models.layers import (
    SharedDraws,
    dense_init,
    promoted_linear,
)
from deepards_tpu_torch.models.recurrent import LSTM
from deepards_tpu_torch.models.transformer import Transformer

TIME_LAYERS = ("none", "lstm", "transformer")


class _Tower(nn.Module):
    """The backbone and the time layer over each window's features."""

    def __init__(self, breath_block, time_layer="none", hidden_units=16,
                 bn_scope="batch"):
        super().__init__()
        _check_bn_scope(bn_scope)
        if time_layer not in TIME_LAYERS:
            raise ValueError("siamese_time_layer must be one of {}".format(
                TIME_LAYERS))
        self.breath_block = breath_block
        self.bn_scope = bn_scope
        self.time_layer = time_layer
        width = breath_block.n_out_filters
        if time_layer == "lstm":
            self.lstm = LSTM(width, hidden_units)
            width = hidden_units
        elif time_layer == "transformer":
            self.transformer = Transformer(width, hidden_units, num_blocks=2,
                                           num_heads=4)
        self.out_features = width

    def reset_parameters(self, generator=None):
        self.breath_block.reset_parameters(generator)
        if self.time_layer == "lstm":
            self.lstm.reset_parameters(generator)
        elif self.time_layer == "transformer":
            self.transformer.reset_parameters(generator)

    def tower(self, x, deterministic, generator, copies=1):
        """(B, S, C, L) -> (B, S, F): ``copies`` stacks of B / copies
        samples, each as its own call (see the module docstring)."""
        out = _window_features(self.breath_block, x, self.bn_scope,
                               deterministic, generator, copies)
        if self.time_layer == "lstm":
            out = self.lstm(out)[1]
        elif self.time_layer == "transformer":
            if copies > 1 and generator is not None:
                generator = SharedDraws(generator, copies)
            out = self.transformer(out, deterministic, generator)
        return out


class _SiameseNetwork(_Tower):
    def __init__(self, breath_block, n_sub_batches, time_layer="none",
                 hidden_units=16, bn_scope="batch"):
        super().__init__(breath_block, time_layer, hidden_units, bn_scope)
        self.linear_intermediate = nn.Linear(self.out_features, 2)
        self.linear_final = nn.Linear(2 * n_sub_batches, 2)

    def reset_parameters(self, generator=None):
        super().reset_parameters(generator)
        dense_init(self.linear_intermediate, generator)
        dense_init(self.linear_final, generator)
        return self

    def compare(self, x_out, c_out):
        diff = promoted_linear((c_out - x_out).abs(),
                               self.linear_intermediate)
        return promoted_linear(diff.reshape(diff.shape[0], -1),
                               self.linear_final)

    def forward(self, x, compr, deterministic=False, generator=None,
                negative=None):
        x_out = self.tower(x, deterministic, generator)
        if negative is None:
            return self.compare(
                x_out, self.tower(compr, deterministic, generator))
        both = self.tower(torch.cat([compr, negative]), deterministic,
                          generator, copies=2)
        pos, neg = both.chunk(2)
        return torch.stack([self.compare(x_out, pos),
                            self.compare(x_out, neg)])


class SiameseCNNLinearNetwork(_SiameseNetwork):
    """(reference: siamese.py:57-85)"""

    def __init__(self, breath_block, n_sub_batches, bn_scope="batch"):
        super().__init__(breath_block, n_sub_batches, bn_scope=bn_scope)


class SiameseCNNLSTMNetwork(_SiameseNetwork):
    """The LSTM-tower variant: one LSTM over both sides' windows."""

    def __init__(self, breath_block, n_sub_batches, hidden_units=16,
                 bn_scope="batch"):
        super().__init__(breath_block, n_sub_batches, "lstm", hidden_units,
                         bn_scope)


class SiameseCNNTransformerNetwork(_SiameseNetwork):
    """(reference: siamese.py:87-120): one transformer, 2 blocks and 4
    heads of ``hidden_units // 4``, over both sides' windows."""

    def __init__(self, breath_block, n_sub_batches, hidden_units=16,
                 bn_scope="batch"):
        super().__init__(breath_block, n_sub_batches, "transformer",
                         hidden_units, bn_scope)


class SiameseARDSClassifier(_Tower):
    """A pretrained siamese tower for ARDS classification
    (reference: siamese.py:16-54)."""

    def __init__(self, breath_block, n_sub_batches, time_layer="none",
                 hidden_units=16, bn_scope="batch"):
        super().__init__(breath_block, time_layer, hidden_units, bn_scope)
        self.linear_final = nn.Linear(n_sub_batches * self.out_features, 2)

    def reset_parameters(self, generator=None):
        super().reset_parameters(generator)
        dense_init(self.linear_final, generator)
        return self

    def forward(self, x, deterministic=False, generator=None, metadata=None):
        out = self.tower(x, deterministic, generator)
        return promoted_linear(out.reshape(out.shape[0], -1),
                               self.linear_final)
