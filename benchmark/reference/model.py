"""Plain float32 reference of the measured networks and their train step.

densenet18-1D (DenseNet-BC: growth 32, blocks (2, 2, 2, 2), 64 initial
features, 1x1 bottlenecks of 4 x 32 channels, dropout 0.2 after each dense
layer, batch-statistic normalization throughout) under two heads:

- ``cnn_linear``: the S windows of a sample through the backbone as one
  batch of B*S rows, their 128 features each flattened to one Linear of
  S*128 -> 2;
- ``cnn_to_nested_lstm``: one patient's W windows, each normalized over
  its own S rows, median-pooled over its S breaths, then an LSTM of 128
  units over the W windows (flax's OptimizedLSTMCell: gates i, f, g, o,
  input kernels without bias, hidden kernels with one), then a Linear of
  128 -> 2 on every window.

The loss is BCE with logits, averaged over the two outputs of a row and
then over the rows that a 0/1 mask keeps.  The step clamps every gradient
element to +-clip, adds the coupled weight decay and takes Nesterov SGD
(torch's convention: the first momentum is the first decayed gradient).

Everything is plain ``torch`` and ``torch.nn.functional`` over a dict of
tensors; parameters carry the names the measured modules give them, so
one set of weights can be handed to both.  Dropout takes its keep masks
as arguments (``dropout_masks`` draws them).  ``quant`` is applied where
a lower-precision run rounds (inputs, weights and each operation's
output); the reference itself passes none.
"""
import math

import torch
import torch.nn.functional as F

GROWTH = 32
BLOCKS = (2, 2, 2, 2)
INIT_FEATURES = 64
BN_SIZE = 4
DROP_RATE = 0.2
EPS = 1e-5
LSTM_UNITS = 128
GATES = ("i", "f", "g", "o")
WINDOW = 224  # samples a breath holds


def _ident(x):
    return x


def n_features():
    """The backbone's output features (128 for densenet18)."""
    n = INIT_FEATURES
    for i, layers in enumerate(BLOCKS):
        n += layers * GROWTH
        if i != len(BLOCKS) - 1:
            n //= 2
    return n


def param_spec(network, n_sub_batches, in_channels=1):
    """[(name, shape, init)] of every parameter.  ``init`` is ("normal",
    std), ("ones",), ("zeros",) or ("orthogonal",)."""
    spec = []

    def conv(name, cout, cin, k):
        spec.append((name, (cout, cin, k),
                     ("normal", math.sqrt(2.0 / (k * cout)))))

    def norm(name, c):
        spec.append((name + ".weight", (c,), ("ones",)))
        spec.append((name + ".bias", (c,), ("zeros",)))

    def dense(name, cout, cin, bias=True):
        spec.append((name + ".weight", (cout, cin),
                     ("normal", 1.0 / math.sqrt(cin))))
        if bias:
            spec.append((name + ".bias", (cout,), ("zeros",)))

    bb = "breath_block."
    conv(bb + "conv0.weight", INIT_FEATURES, in_channels, 7)
    norm(bb + "norm0", INIT_FEATURES)
    n, layer = INIT_FEATURES, 0
    for i, layers in enumerate(BLOCKS):
        for _ in range(layers):
            pre = "{}dense_layers.{}.".format(bb, layer)
            norm(pre + "norm1", n)
            conv(pre + "conv1.weight", BN_SIZE * GROWTH, n, 1)
            norm(pre + "norm2", BN_SIZE * GROWTH)
            conv(pre + "conv2.weight", GROWTH, BN_SIZE * GROWTH, 3)
            n += GROWTH
            layer += 1
        if i != len(BLOCKS) - 1:
            pre = "{}transitions.{}.".format(bb, i)
            norm(pre + "norm", n)
            conv(pre + "conv.weight", n // 2, n, 1)
            n //= 2
    norm(bb + "norm5", n)
    if network == "cnn_linear":
        dense("head", 2, n_sub_batches * n)
    elif network == "cnn_to_nested_lstm":
        for g in GATES:
            dense("lstm.input." + g, LSTM_UNITS, n, bias=False)
        for g in GATES:
            spec.append(("lstm.hidden.{}.weight".format(g),
                         (LSTM_UNITS, LSTM_UNITS), ("orthogonal",)))
            spec.append(("lstm.hidden.{}.bias".format(g), (LSTM_UNITS,),
                         ("zeros",)))
        dense("head", 2, LSTM_UNITS)
    else:
        raise ValueError("no reference for network {}".format(network))
    return spec


def dropout_shapes(rows, length=WINDOW):
    """The (rows, 32, L) shape of each dense layer's dropout, in order."""
    shapes = []
    length = (length + 2 * 3 - 7) // 2 + 1  # conv0, stride 2
    length = (length + 2 - 3) // 2 + 1      # max pool 3, stride 2
    for i, layers in enumerate(BLOCKS):
        shapes += [(rows, GROWTH, length)] * layers
        if i != len(BLOCKS) - 1:
            length //= 2
    return shapes


def dropout_masks(generator, rows, device, length=WINDOW):
    """A step's keep masks: each dense layer draws one uniform per
    element of its output from ``generator`` (on ``device``), in layer
    order, and keeps those below 1 - rate."""
    return [torch.rand(shape, generator=generator, device=device)
            < 1.0 - DROP_RATE for shape in dropout_shapes(rows, length)]


def batch_norm(x, weight, bias, groups=1, row_mask=None):
    """Normalize (N, C, L) by the statistics of its rows, split into
    ``groups`` equal consecutive groups, over the rows that ``row_mask``
    (one entry a row of a group) keeps: the mean, then the biased
    variance, per channel over the kept rows and L."""
    n, c, length = x.shape
    rows = n // groups
    xg = x.reshape(groups, rows, c, length)
    if row_mask is None:
        row_mask = torch.ones(rows, dtype=x.dtype, device=x.device)
    m = row_mask.to(x.dtype).reshape(1, rows, 1, 1)
    count = torch.clamp(m.sum(), min=1.0) * length
    mean = (xg * m).sum(dim=(1, 3), keepdim=True) / count
    var = ((xg - mean).square() * m).sum(dim=(1, 3), keepdim=True) / count
    y = (xg - mean) / torch.sqrt(var + EPS)
    y = y * weight.reshape(1, 1, c, 1) + bias.reshape(1, 1, c, 1)
    return y.reshape(n, c, length)


def backbone(p, x, masks=None, groups=1, row_mask=None, quant=None):
    """(N, C, 224) windows' breaths -> (N, 128) features."""
    q = quant or _ident
    w = {k: q(v) for k, v in p.items() if k.startswith("breath_block.")}

    def norm_relu(h, name):
        return q(F.relu(batch_norm(h, w[name + ".weight"], w[name + ".bias"],
                                   groups, row_mask)))

    bb = "breath_block."
    h = q(F.conv1d(q(x), w[bb + "conv0.weight"], stride=2, padding=3))
    h = norm_relu(h, bb + "norm0")
    h = F.max_pool1d(F.pad(h, (1, 1), value=float("-inf")), 3, 2)
    layer = 0
    for i, layers in enumerate(BLOCKS):
        for _ in range(layers):
            pre = "{}dense_layers.{}.".format(bb, layer)
            y = norm_relu(h, pre + "norm1")
            y = q(F.conv1d(y, w[pre + "conv1.weight"]))
            y = norm_relu(y, pre + "norm2")
            y = q(F.conv1d(y, w[pre + "conv2.weight"], padding=1))
            if masks is not None:
                y = q(torch.where(masks[layer], y / (1.0 - DROP_RATE),
                                  torch.zeros_like(y)))
            h = torch.cat([h, y], dim=1)
            layer += 1
        if i != len(BLOCKS) - 1:
            pre = "{}transitions.{}.".format(bb, i)
            y = norm_relu(h, pre + "norm")
            y = q(F.conv1d(y, w[pre + "conv.weight"]))
            h = q(F.avg_pool1d(y, 2, 2))
    h = norm_relu(h, bb + "norm5")
    return q(h.mean(dim=2))  # the final length is 7: a pool over all of it


def bce(logits, target, weights=None):
    """BCE with logits, the mean of a row's outputs, then the mean over
    the rows, weighted by 0/1 ``weights`` (divided by at least 1)."""
    per_row = F.binary_cross_entropy_with_logits(
        logits, target, reduction="none").mean(dim=-1)
    if weights is None:
        return per_row.mean()
    return (per_row * weights).sum() / torch.clamp(weights.sum(), min=1.0)


def cnn_linear_logits(p, x, row_mask=None, masks=None, quant=None):
    """(B, S, C, L) normalized windows -> (B, 2) logits; ``row_mask`` (B,)
    drops pad samples from the norms' statistics."""
    b, s, c, length = x.shape
    rows = None if row_mask is None else row_mask.repeat_interleave(s)
    feats = backbone(p, x.reshape(b * s, c, length), masks, 1, rows, quant)
    q = quant or _ident
    return q(F.linear(feats.reshape(b, -1), q(p["head.weight"]),
                      q(p["head.bias"])))


def window_medians(feats, s):
    """(W*S, F) -> (W, F): the median over each window's S breaths, the
    mean of the two middle values at an even S."""
    srt = torch.sort(feats.reshape(-1, s, feats.shape[-1]), dim=1).values
    return (srt[:, (s - 1) // 2] + srt[:, s // 2]) * 0.5


def nested_medians(p, x, masks=None, quant=None):
    """(W, S, C, L) normalized windows -> (W, 128) window medians, each
    window normalized over its own S rows."""
    w, s, c, length = x.shape
    feats = backbone(p, x.reshape(w * s, c, length), masks, w, None, quant)
    return window_medians(feats, s)


def lstm_head(p, medians, quant=None):
    """(W, 128) window medians -> (W, 2) logits: the LSTM over the
    windows in order from a zero carry, then the head on each window."""
    q = quant or _ident
    w_i = torch.cat([q(p["lstm.input.{}.weight".format(g)]) for g in GATES])
    w_h = torch.cat([q(p["lstm.hidden.{}.weight".format(g)]) for g in GATES])
    b_h = torch.cat([q(p["lstm.hidden.{}.bias".format(g)]) for g in GATES])
    xi = q(medians @ w_i.t())
    h = c = medians.new_zeros(LSTM_UNITS)
    outs = []
    for t in range(medians.shape[0]):
        i, f, g, o = (xi[t] + h @ w_h.t() + b_h).chunk(4)
        c = torch.sigmoid(f) * c + torch.sigmoid(i) * torch.tanh(g)
        h = torch.sigmoid(o) * torch.tanh(c)
        outs.append(h)
    out = torch.stack(outs)
    return q(F.linear(out, q(p["head.weight"]), q(p["head.bias"])))


def sgd_step(params, grads, momentum, lr, weight_decay, clip, mu=0.9):
    """One clipped Nesterov SGD step in place: each gradient element
    clamped to +-clip, the decay added, then the momentum (started as the
    first decayed gradient when ``momentum`` lacks the name)."""
    with torch.no_grad():
        for name, param in params.items():
            d = grads[name].clamp(-clip, clip) + weight_decay * param
            buf = momentum.get(name)
            buf = d.clone() if buf is None else buf.mul_(mu).add_(d)
            momentum[name] = buf
            param.sub_(lr * (d + mu * buf))
