"""The shared pieces of the plain float32 reference: the backbone, its
norms and dropout, the loss and the train step.  Each network's own
leaves and forward past the backbone are a module of
``reference/networks``, found by the network's name.

densenet18-1D (DenseNet-BC: growth 32, blocks (2, 2, 2, 2), 64 initial
features, 1x1 bottlenecks of 4 x 32 channels, dropout 0.2 after each dense
layer, batch-statistic normalization throughout) turns each breath of a
window into 128 features.  ``features`` runs it over a step: a batch of
samples, whose B*S breaths are normalized together (a 0/1 row mask drops
pad samples from the statistics), or one patient's windows, each
normalized over its own S breaths.

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
WINDOW = 224  # samples a breath holds
BACKBONE = "breath_block."  # the names of the backbone's leaves


def identity(x):
    return x


def n_features():
    """The backbone's output features (128 for densenet18)."""
    n = INIT_FEATURES
    for i, layers in enumerate(BLOCKS):
        n += layers * GROWTH
        if i != len(BLOCKS) - 1:
            n //= 2
    return n


def conv_spec(name, cout, cin, k):
    """A convolution's kernel: normal, std sqrt(2 / (k * out))."""
    return [(name, (cout, cin, k), ("normal", math.sqrt(2.0 / (k * cout))))]


def norm_spec(name, c):
    """A norm's scale (ones) and shift (zeros)."""
    return [(name + ".weight", (c,), ("ones",)),
            (name + ".bias", (c,), ("zeros",))]


def dense_spec(name, cout, cin, bias=True):
    """A Linear's kernel (normal, std 1 / sqrt(fan in)) and bias (zeros)."""
    spec = [(name + ".weight", (cout, cin), ("normal", 1.0 / math.sqrt(cin)))]
    if bias:
        spec.append((name + ".bias", (cout,), ("zeros",)))
    return spec


def backbone_spec(in_channels=1):
    """[(name, shape, init)] of the backbone's leaves, in the order a
    network's ``param_spec`` lists them first."""
    bb = BACKBONE
    spec = conv_spec(bb + "conv0.weight", INIT_FEATURES, in_channels, 7)
    spec += norm_spec(bb + "norm0", INIT_FEATURES)
    n, layer = INIT_FEATURES, 0
    for i, layers in enumerate(BLOCKS):
        for _ in range(layers):
            pre = "{}dense_layers.{}.".format(bb, layer)
            spec += norm_spec(pre + "norm1", n)
            spec += conv_spec(pre + "conv1.weight", BN_SIZE * GROWTH, n, 1)
            spec += norm_spec(pre + "norm2", BN_SIZE * GROWTH)
            spec += conv_spec(pre + "conv2.weight", GROWTH,
                              BN_SIZE * GROWTH, 3)
            n += GROWTH
            layer += 1
        if i != len(BLOCKS) - 1:
            pre = "{}transitions.{}.".format(bb, i)
            spec += norm_spec(pre + "norm", n)
            spec += conv_spec(pre + "conv.weight", n // 2, n, 1)
            n //= 2
    return spec + norm_spec(bb + "norm5", n)


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
    q = quant or identity
    w = {k: q(v) for k, v in p.items() if k.startswith(BACKBONE)}

    def norm_relu(h, name):
        return q(F.relu(batch_norm(h, w[name + ".weight"], w[name + ".bias"],
                                   groups, row_mask)))

    bb = BACKBONE
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


def features(p, x, per_window, masks=None, row_mask=None, quant=None):
    """(N, S, C, L) normalized windows -> (N, S, 128) per-breath
    features: the N*S breaths through the backbone, normalized each
    window on its own (``per_window``: a patient's windows) or all
    together, with ``row_mask`` (N,) dropping pad samples from the
    statistics."""
    n, s, c, length = x.shape
    rows = None if row_mask is None else row_mask.repeat_interleave(s)
    feats = backbone(p, x.reshape(n * s, c, length), masks,
                     n if per_window else 1, rows, quant)
    return feats.reshape(n, s, -1)


def window_medians(feats):
    """(W, S, F) -> (W, F): the median over each window's S breaths, the
    mean of the two middle values at an even S."""
    s = feats.shape[1]
    srt = torch.sort(feats, dim=1).values
    return (srt[:, (s - 1) // 2] + srt[:, s // 2]) * 0.5


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
