"""Recurrent and transformer networks over the windows of a sample, and
over each window's samples.

Counterpart of ``deepards_tpu/models/recurrent.py``.  ``CNNLSTMNetwork``,
``CNNLSTMDoubleLinearNetwork`` and ``CNNTransformerNetwork`` take each
window's backbone features (one (B*S)-row call) and run an ``LSTM`` or a
``Transformer`` over the S windows.  ``LSTMOnlyNetwork``,
``LSTMOnlyWithPacking`` and ``DoubleLSTMNetwork`` have no backbone: an
``LSTM`` runs over each window's L raw samples.

``LSTM`` computes what flax's ``OptimizedLSTMCell`` under ``nn.RNN``
computes, with its parameters: per gate (i, f, g, o) an input kernel
without bias and a hidden kernel with a bias, held as ``nn.Linear``s in
``input`` and ``hidden``.  The input projection of all S windows is one
matmul; then S steps of ``h @ W_h + b`` (``ops/lstm.py`` ``recurrence``:
on the card the persistent kernels of ``ops/csrc/lstm.cu``, on the CPU
and under a ``torch.func`` transform a loop of stock ops).  Precision
follows flax's ``promote_dtype``: under bfloat16 compute the input
projection is bfloat16 x bfloat16, while the carry starts as float32
zeros, so the recurrent projection, the gates, the carry and the outputs
are float32.

``SimpleRNN`` is flax's ``SimpleCell`` under ``nn.RNN`` (the nested RNN's
cell): tanh(x W_i + b_i + h W_h), the bias on the input Dense and none
on the hidden one, the carry starting at float32 zeros.
"""
import torch
import torch.nn.functional as F
from torch import nn

from deepards_tpu_torch.models.heads import (
    _check_bn_scope,
    _window_features,
)
from deepards_tpu_torch.models.layers import dense_init, promoted_linear
from deepards_tpu_torch.models.transformer import Transformer
from deepards_tpu_torch.ops import lstm as lstm_ops

GATES = ("i", "f", "g", "o")
SEQ_LEN = 224  # samples a window holds: the LSTM-only networks' Dense widths


class LSTM(nn.Module):
    """(B, S, F) -> ((c, h), (B, S, H) outputs), flax's gate layout."""

    def __init__(self, in_features, hidden):
        super().__init__()
        self.hidden_size = hidden
        self.input = nn.ModuleDict(
            {g: nn.Linear(in_features, hidden, bias=False) for g in GATES})
        self.hidden = nn.ModuleDict(
            {g: nn.Linear(hidden, hidden) for g in GATES})

    def reset_parameters(self, generator=None):
        """flax's init: input kernels lecun normal, recurrent kernels
        orthogonal, biases 0, drawn from ``generator``."""
        for g in GATES:
            dense_init(self.input[g], generator)
            nn.init.orthogonal_(self.hidden[g].weight, generator=generator)
            nn.init.zeros_(self.hidden[g].bias)
        return self

    def zero_carry(self, batch, device=None):
        """A float32 zero carry (c, h), as flax's ``initialize_carry``."""
        zeros = torch.zeros(batch, self.hidden_size, device=device)
        return zeros, zeros

    def forward(self, x, carry=None):
        w_i = torch.cat([self.input[g].weight for g in GATES])
        w_h = torch.cat([self.hidden[g].weight for g in GATES])
        b_h = torch.cat([self.hidden[g].bias for g in GATES])
        in_dtype = torch.promote_types(x.dtype, w_i.dtype)
        xi = F.linear(x.to(in_dtype), w_i.to(in_dtype))  # (B, S, 4H)
        if carry is None:
            carry = self.zero_carry(x.shape[0], x.device)
        # the carry at least float32, as the weights promote it (float64
        # for a float64 model)
        h_dtype = torch.promote_types(carry[1].dtype, w_h.dtype)
        c, h = (t.to(h_dtype) for t in carry)
        w_h, b_h = w_h.to(h_dtype), b_h.to(h_dtype)
        return lstm_ops.recurrence(xi, w_h, b_h, c, h)


class SimpleRNN(nn.Module):
    """(B, S, F) -> (B, S, H) outputs of flax's ``SimpleCell``: ``input``
    is its Dense ``i`` (with the bias), ``hidden`` its Dense ``h``.  The
    precision follows ``LSTM``'s: the input projection in the promoted
    type of input and params, the carry and outputs at least float32."""

    def __init__(self, in_features, hidden):
        super().__init__()
        self.hidden_size = hidden
        self.input = nn.Linear(in_features, hidden)
        self.hidden = nn.Linear(hidden, hidden, bias=False)

    def reset_parameters(self, generator=None):
        """flax's init: the input kernel lecun normal, the recurrent
        kernel orthogonal, the bias 0."""
        dense_init(self.input, generator)
        nn.init.orthogonal_(self.hidden.weight, generator=generator)
        return self

    def forward(self, x):
        xi = promoted_linear(x, self.input)  # (B, S, H)
        w_h = self.hidden.weight
        h_dtype = torch.promote_types(torch.float32, w_h.dtype)
        h = torch.zeros(x.shape[0], self.hidden_size, dtype=h_dtype,
                        device=x.device)
        w_h = w_h.to(h_dtype)
        outs = []
        for s in range(x.shape[1]):
            h = torch.tanh(xi[:, s] + F.linear(h, w_h))
            outs.append(h)
        return torch.stack(outs, dim=1)


class _CNNLSTMBase(nn.Module):
    """Window features, the metadata appended to them (or, with
    ``bm_to_linear``, to the LSTM's outputs), the LSTM over the windows."""

    def __init__(self, breath_block, lstm_hidden_units=16,
                 metadata_features=0, bm_to_linear=False, bn_scope="batch"):
        super().__init__()
        _check_bn_scope(bn_scope)
        self.breath_block = breath_block
        self.bn_scope = bn_scope
        self.metadata_features = metadata_features
        self.bm_to_linear = bm_to_linear
        lstm_in = breath_block.n_out_filters
        self.hidden_size = lstm_hidden_units
        if not bm_to_linear:
            lstm_in += metadata_features
            self.hidden_size += metadata_features
        self.lstm = LSTM(lstm_in, self.hidden_size)
        # what the Dense after the LSTM reads a window
        self.out_features = self.hidden_size + (
            metadata_features if bm_to_linear else 0)

    def _reset_backbone_and_lstm(self, generator):
        self.breath_block.reset_parameters(generator)
        self.lstm.reset_parameters(generator)

    def _lstm_outputs(self, x, deterministic, generator, metadata, carry):
        feats = _window_features(
            self.breath_block, x, self.bn_scope, deterministic, generator)
        if self.metadata_features and metadata is not None and \
                not self.bm_to_linear:
            feats = _concat(feats, metadata)
        carry, out = self.lstm(feats, carry)
        if self.bm_to_linear and metadata is not None:
            out = _concat(out, metadata)
        return carry, out


def _concat(a, b):
    """``a`` and ``b`` joined on the last axis in their promoted type, as
    ``jnp.concatenate`` does."""
    dtype = torch.promote_types(a.dtype, b.dtype)
    return torch.cat([a.to(dtype), b.to(dtype)], dim=-1)


class CNNLSTMNetwork(_CNNLSTMBase):
    """Per-window logits (B, S, 2) and the LSTM's final carry: ``forward``
    returns ``(logits, (c, h))`` and takes an optional ``carry`` to start
    from (the stateful unshuffled fold's), as the JAX network does."""

    def __init__(self, *args, **kwargs):
        super().__init__(*args, **kwargs)
        self.head = nn.Linear(self.out_features, 2)

    def reset_parameters(self, generator=None):
        self._reset_backbone_and_lstm(generator)
        dense_init(self.head, generator)
        return self

    def forward(self, x, deterministic=False, generator=None, metadata=None,
                carry=None):
        carry, out = self._lstm_outputs(x, deterministic, generator,
                                        metadata, carry)
        return promoted_linear(out, self.head), carry


class CNNLSTMDoubleLinearNetwork(_CNNLSTMBase):
    """The LSTM's outputs of all S windows flattened -> Linear(hidden) ->
    Linear(2): (B, 2) logits."""

    def __init__(self, breath_block, n_sub_batches, lstm_hidden_units=16,
                 metadata_features=0, bm_to_linear=False, bn_scope="batch"):
        super().__init__(breath_block, lstm_hidden_units, metadata_features,
                         bm_to_linear, bn_scope)
        self.layers = nn.ModuleList([
            nn.Linear(n_sub_batches * self.out_features, self.hidden_size),
            nn.Linear(self.hidden_size, 2)])

    def reset_parameters(self, generator=None):
        self._reset_backbone_and_lstm(generator)
        for layer in self.layers:
            dense_init(layer, generator)
        return self

    def forward(self, x, deterministic=False, generator=None, metadata=None):
        _, h = self._lstm_outputs(x, deterministic, generator, metadata,
                                  None)
        h = h.reshape(h.shape[0], -1)
        for layer in self.layers:
            h = promoted_linear(h, layer)
        return h


def _sample_sequences(x):
    """(B, S, C, L) -> (B*S, L, C) by reshape, as the JAX networks have it
    (``x.reshape(b * s, l, c)``): not a transpose, so with C > 1
    (``--with-fft``) step t reads samples 2t and 2t + 1 of the channels
    laid end to end."""
    b, s, c, length = x.shape
    return x.reshape(b * s, length, c)


class LSTMOnlyNetwork(nn.Module):
    """An LSTM over each window's L raw samples, a Dense over each window's
    L outputs, a Dense over the S windows' results: (B, 2) logits.
    ``layers`` are flax's ``Dense_0`` and ``Dense_1``."""

    def __init__(self, n_sub_batches, in_channels=1, lstm_hidden_units=16,
                 intermediate_features=16):
        super().__init__()
        self.lstm = LSTM(in_channels, lstm_hidden_units)
        self.layers = nn.ModuleList([
            nn.Linear(SEQ_LEN * lstm_hidden_units, intermediate_features),
            nn.Linear(n_sub_batches * intermediate_features, 2)])

    def reset_parameters(self, generator=None):
        self.lstm.reset_parameters(generator)
        for layer in self.layers:
            dense_init(layer, generator)
        return self

    def sample_outputs(self, x):
        """(B*S, L, H): the LSTM's output at every sample."""
        return self.lstm(_sample_sequences(x))[1]

    def forward(self, x, deterministic=False, generator=None, metadata=None):
        b, s = x.shape[:2]
        out = self.sample_outputs(x).reshape(b, s, -1)
        h = promoted_linear(out, self.layers[0])
        return promoted_linear(h.reshape(b, -1), self.layers[1])


class LSTMOnlyWithPacking(LSTMOnlyNetwork):
    """``LSTMOnlyNetwork`` with each window's outputs zeroed from its
    length on: the reference's pack/pad round trip.  The length is the
    first all-zero sample's index plus 1; no such sample, or one at index
    0, gives L."""

    def __init__(self, n_sub_batches, in_channels=1, lstm_hidden_units=16,
                 intermediate_features=64):
        super().__init__(n_sub_batches, in_channels, lstm_hidden_units,
                         intermediate_features)

    def sample_outputs(self, x):
        seq = _sample_sequences(x)
        out = self.lstm(seq)[1]
        length = seq.shape[1]
        first_zero = torch.argmax((seq == 0).all(dim=-1).int(), dim=1)
        lens = torch.where(first_zero == 0, length - 1, first_zero) + 1
        t = torch.arange(length, device=x.device)
        keep = t[None, :, None] < lens[:, None, None]
        return torch.where(keep, out, torch.zeros_like(out))


class DoubleLSTMNetwork(nn.Module):
    """An LSTM over each window's samples, a second over the S windows'
    flattened outputs, a Dense over all S: (B, 2) logits."""

    def __init__(self, n_sub_batches, in_channels=1, lstm_hidden_units=16,
                 intermediate_features=16):
        super().__init__()
        self.lstm = LSTM(in_channels, lstm_hidden_units)
        self.sequence_lstm = LSTM(SEQ_LEN * lstm_hidden_units,
                                  intermediate_features)
        self.head = nn.Linear(n_sub_batches * intermediate_features, 2)

    def reset_parameters(self, generator=None):
        self.lstm.reset_parameters(generator)
        self.sequence_lstm.reset_parameters(generator)
        dense_init(self.head, generator)
        return self

    def forward(self, x, deterministic=False, generator=None, metadata=None):
        b, s = x.shape[:2]
        out = self.lstm(_sample_sequences(x))[1].reshape(b, s, -1)
        out = self.sequence_lstm(out)[1]
        return promoted_linear(out.reshape(b, -1), self.head)


class CNNTransformerNetwork(nn.Module):
    """Window features (and the metadata, or with ``bm_to_linear`` the
    metadata beside the transformer's outputs) through a ``Transformer``
    over the S windows (4 heads of ``hidden_units // 4``), then per-window
    logits (B, S, 2)."""

    def __init__(self, breath_block, hidden_units=16, num_blocks=2,
                 metadata_features=0, bm_to_linear=False, bn_scope="batch"):
        super().__init__()
        _check_bn_scope(bn_scope)
        self.breath_block = breath_block
        self.bn_scope = bn_scope
        self.metadata_features = metadata_features
        self.bm_to_linear = bm_to_linear
        width = breath_block.n_out_filters + (
            0 if bm_to_linear else metadata_features)
        self.transformer = Transformer(width, hidden_units, num_blocks,
                                       num_heads=4)
        self.head = nn.Linear(
            width + (metadata_features if bm_to_linear else 0), 2)

    def reset_parameters(self, generator=None):
        self.breath_block.reset_parameters(generator)
        self.transformer.reset_parameters(generator)
        dense_init(self.head, generator)
        return self

    def forward(self, x, deterministic=False, generator=None, metadata=None):
        feats = _window_features(
            self.breath_block, x, self.bn_scope, deterministic, generator)
        if self.metadata_features and metadata is not None and \
                not self.bm_to_linear:
            feats = _concat(feats, metadata)
        out = self.transformer(feats, deterministic, generator)
        if self.bm_to_linear and metadata is not None:
            out = _concat(out, metadata)
        return promoted_linear(out, self.head)
