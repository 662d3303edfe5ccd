"""``cnn_to_nested_lstm``: a step is one patient.  Each window's breath
features are median-pooled over its S breaths, an LSTM of 128 units runs
over the W windows in order from a zero carry (flax's
OptimizedLSTMCell: gates i, f, g, o, input kernels without bias, hidden
kernels with one), then a Linear of 128 -> 2 on every window.  The LSTM
is causal, so a patient's real windows give the same logits with or
without pad windows after them."""
import torch
import torch.nn.functional as F

from benchmark.reference import model

STEP = "patient"
UNITS = 128
GATES = ("i", "f", "g", "o")


def param_spec(n_sub_batches, in_channels=1):
    spec = model.backbone_spec(in_channels)
    for g in GATES:
        spec += model.dense_spec("lstm.input." + g, UNITS, model.n_features(),
                                 bias=False)
    for g in GATES:
        spec.append(("lstm.hidden.{}.weight".format(g), (UNITS, UNITS),
                     ("orthogonal",)))
        spec.append(("lstm.hidden.{}.bias".format(g), (UNITS,), ("zeros",)))
    return spec + model.dense_spec("head", 2, UNITS)


def logits(p, feats, quant=None):
    """(W, S, F) -> (W, 2)."""
    q = quant or model.identity
    medians = model.window_medians(feats)
    w_i = torch.cat([q(p["lstm.input.{}.weight".format(g)]) for g in GATES])
    w_h = torch.cat([q(p["lstm.hidden.{}.weight".format(g)]) for g in GATES])
    b_h = torch.cat([q(p["lstm.hidden.{}.bias".format(g)]) for g in GATES])
    xi = q(medians @ w_i.t())
    h = c = medians.new_zeros(UNITS)
    outs = []
    for t in range(medians.shape[0]):
        i, f, g, o = (xi[t] + h @ w_h.t() + b_h).chunk(4)
        c = torch.sigmoid(f) * c + torch.sigmoid(i) * torch.tanh(g)
        h = torch.sigmoid(o) * torch.tanh(c)
        outs.append(h)
    out = torch.stack(outs)
    return q(F.linear(out, q(p["head.weight"]), q(p["head.bias"])))
