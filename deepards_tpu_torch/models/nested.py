"""Whole-patient "super batch" networks: each window's median-pooled
backbone features, then an RNN, an LSTM or a Transformer over the
patient's windows.

Counterpart of ``deepards_tpu/models/nested.py``.  Input is (1, W, S, C,
L), one patient's W windows ((W, S, C, L) is read as the same); output
is (1, W, 2), a logit pair per window.  The backbone normalizes each
window on its own, as the JAX package's per-window ``nn.vmap`` does, here
as one (W*S)-row call with ``groups=W``; dropout draws per row, so per
window.  So a zero pad window changes only its own features, which the
causal RNN and LSTM never carry back to earlier windows and the
transformer leaves out of attention through ``window_mask``.
"""
import torch
from torch import nn

from deepards_tpu_torch.models.heads import _window_features
from deepards_tpu_torch.models.layers import dense_init, promoted_linear
from deepards_tpu_torch.models.recurrent import LSTM, SimpleRNN
from deepards_tpu_torch.models.transformer import Transformer

INTERMEDIATE_UNITS = 128


def bucket(n):
    """The windows a patient of ``n`` is padded to: the next power of two
    (1 for n <= 1)."""
    b = 1
    while b < n:
        b *= 2
    return b


def window_medians(feats):
    """(W, S, F) -> (W, F): the median over S as ``jnp.median`` takes it,
    the mean of the two middle sorted values at an even S (its gradient
    half to each)."""
    s = feats.shape[1]
    srt = torch.sort(feats, dim=1).values
    return (srt[:, (s - 1) // 2] + srt[:, s // 2]) * 0.5


def nested_features(breath_block, x, deterministic=False, generator=None):
    """(1, W, S, C, L) -> (1, W, F): each window's backbone features with
    its own normalization statistics, median-pooled over its breaths."""
    if x.ndim == 5:
        x = x[0]
    feats = _window_features(breath_block, x, "sequence", deterministic,
                             generator)
    return window_medians(feats)[None]


class _NestedNetwork(nn.Module):
    """The backbone, a sequence layer over the windows (``sequence``), and
    a Linear ``head``, registered in that order by each network."""

    def __init__(self, breath_block):
        super().__init__()
        self.breath_block = breath_block

    def reset_parameters(self, generator=None):
        self.breath_block.reset_parameters(generator)
        self.sequence_layer().reset_parameters(generator)
        dense_init(self.head, generator)
        return self

    def forward(self, x, deterministic=False, generator=None, metadata=None,
                window_mask=None):
        out = nested_features(self.breath_block, x, deterministic, generator)
        out = self.sequence(out, deterministic, generator, window_mask)
        return promoted_linear(out, self.head)


class CNNToNestedRNNNetwork(_NestedNetwork):
    def __init__(self, breath_block):
        super().__init__(breath_block)
        self.rnn = SimpleRNN(breath_block.n_out_filters, INTERMEDIATE_UNITS)
        self.head = nn.Linear(INTERMEDIATE_UNITS, 2)

    def sequence_layer(self):
        return self.rnn

    def sequence(self, out, deterministic, generator, window_mask):
        return self.rnn(out)


class CNNToNestedLSTMNetwork(_NestedNetwork):
    def __init__(self, breath_block):
        super().__init__(breath_block)
        self.lstm = LSTM(breath_block.n_out_filters, INTERMEDIATE_UNITS)
        self.head = nn.Linear(INTERMEDIATE_UNITS, 2)

    def sequence_layer(self):
        return self.lstm

    def sequence(self, out, deterministic, generator, window_mask):
        return self.lstm(out)[1]


class CNNToNestedTransformerNetwork(_NestedNetwork):
    def __init__(self, breath_block, transformer_blocks=2):
        super().__init__(breath_block)
        self.transformer = Transformer(
            breath_block.n_out_filters, INTERMEDIATE_UNITS,
            transformer_blocks, num_heads=4)
        self.head = nn.Linear(breath_block.n_out_filters, 2)

    def sequence_layer(self):
        return self.transformer

    def sequence(self, out, deterministic, generator, window_mask):
        return self.transformer(out, deterministic, generator,
                                mask=window_mask)
