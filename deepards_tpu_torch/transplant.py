"""flax parameter tree -> the port's ``state_dict``.

The JAX package's params are a nested dict of flax module names, e.g.
cnn_linear over densenet18

    {"breath_block": {"Conv1d_0": {"Conv_0": {"kernel"}}, "BatchStatNorm_0",
                      "DenseLayer_0".., "Transition_0".., "BatchStatNorm_1"},
     "Dense_0": {"kernel", "bias"}}

(the same tree under either ``bn_scope``).  ``transplant`` accepts it as
nested dicts of arrays, or flat with "a/b/c" keys as
``flax.traverse_util.flatten_dict(params, sep="/")`` gives and as
``np.savez`` of that flat dict stores it.  A bare backbone tree (no
"breath_block" level) maps onto the backbone itself.

Names are mapped by one table per block family (``Family``): a module's
fixed names, and its indexed kinds, where ``Kind_k`` is entry k of a list.
The backbone's family is ResNet when the tree has a ``BasicBlock_i`` or
``Bottleneck_i``, SENet when it has one of the four SE blocks (each with
its ``SEModule_0`` as ``se``, whose ``Conv1d_k`` are ``se.convs.k``),
DenseNet-2D when it has a ``DenseLayer2D_i`` (its convs flax ``Conv_k``
with no ``Conv1d`` around them), DenseNet when it has a ``DenseLayer_i``,
UNet when it has a ``DoubleConv_k`` (``double_convs.k``, each with
``convs.0`` and ``convs.1``; the full network's ``Conv1d_0`` is its
``out_conv``), else a stack of convs (VGG, the autoencoder and its
encoder): ``Conv1d_k``, ``BatchStatNorm_k`` and the decoder's
``ConvTranspose_k`` are ``convs.k``, ``norms.k`` and ``deconvs.k``.  A
network's ``Dense_0`` is its ``head``, unless it has a chain of Dense
layers (``Dense_1`` too), which are ``layers.k``; the siamese networks'
``linear_intermediate`` and ``linear_final`` keep their names;
``OptimizedLSTMCell_0`` is its ``lstm`` (``_1``, the double LSTM's
second, its ``sequence_lstm``), ``SimpleCell_0`` its ``rnn``
(Dense ``i`` the ``input``, ``h`` the ``hidden``), ``Transformer_0`` its
``transformer``, whose ``Block_k`` are ``blocks.k``, each with its
``MultiHeadAttention_0`` as ``attention`` and its ``LayerNorm_k`` and
``Dense_k`` as ``norms.k`` and ``dense.k``.  A nested network's backbone
is one ``breath_block`` shared by its windows.  A PPNet's
``add_on_layers/Conv_k`` are ``add_on_layers.convs.k``, its
``last_layer`` and ``prototype_vectors`` keep their names (the
prototypes their layout too).  The row-band detector's ``Dense_0`` and
``Dense_1`` are its ``layers.0`` and ``layers.1``.

Layouts: conv kernels go from (K, Cin, Cout) to (Cout, Cin, K) and from
(H, W, Cin, Cout) to (Cout, Cin, H, W), Dense kernels (in, out) are
transposed to (out, in), norm scale/bias become weight/bias.
``load_sgd_momentum`` maps the momentum of an optax SGD state the same
way, into a torch SGD's state.
"""
from collections.abc import Mapping
from typing import NamedTuple

import numpy as np
import torch


class Family(NamedTuple):
    """A block family's flax module names -> (port attribute, family of
    the module it names, None when it holds the leaves)."""

    fixed: dict = {}
    indexed: dict = {}  # flax kind -> (port list attribute, family)


_CONV = Family(fixed={"Conv_0": ("", None)})  # flax's Conv in the Conv1d
_DENSE_LAYER = Family(fixed={
    "BatchStatNorm_0": ("norm1", None), "Conv1d_0": ("conv1", _CONV),
    "BatchStatNorm_1": ("norm2", None), "Conv1d_1": ("conv2", _CONV)})
_TRANSITION = Family(fixed={"BatchStatNorm_0": ("norm", None),
                            "Conv1d_0": ("conv", _CONV)})
_DENSENET = Family(
    fixed={"Conv1d_0": ("conv0", _CONV), "BatchStatNorm_0": ("norm0", None),
           "BatchStatNorm_1": ("norm5", None)},
    indexed={"DenseLayer": ("dense_layers", _DENSE_LAYER),
             "Transition": ("transitions", _TRANSITION)})
_DENSE_LAYER_2D = Family(fixed={
    "BatchStatNorm_0": ("norm1", None), "Conv_0": ("conv1", None),
    "BatchStatNorm_1": ("norm2", None), "Conv_1": ("conv2", None)})
_TRANSITION_2D = Family(fixed={"BatchStatNorm_0": ("norm", None),
                               "Conv_0": ("conv", None)})
_DENSENET_2D = Family(
    fixed={"Conv_0": ("conv0", None), "BatchStatNorm_0": ("norm0", None),
           "BatchStatNorm_1": ("norm5", None)},
    indexed={"DenseLayer2D": ("dense_layers", _DENSE_LAYER_2D),
             "Transition2D": ("transitions", _TRANSITION_2D)})
# a ResNet stem and its blocks index convs and norms in creation order
_RESNET_BLOCK = Family(indexed={"Conv1d": ("convs", _CONV),
                                "BatchStatNorm": ("norms", None)})
_RESNET = Family(indexed={**_RESNET_BLOCK.indexed,
                          "BasicBlock": ("blocks", _RESNET_BLOCK),
                          "Bottleneck": ("blocks", _RESNET_BLOCK)})
# SENet's blocks: a ResNet block's lists and the SE gate's two convs
_CONVS = Family(indexed={"Conv1d": ("convs", _CONV)})
_SE_BLOCK = Family(fixed={"SEModule_0": ("se", _CONVS)},
                   indexed=_RESNET_BLOCK.indexed)
_SENET = Family(indexed={
    **_RESNET_BLOCK.indexed,
    **{kind: ("blocks", _SE_BLOCK)
       for kind in ("SEBasicBlock", "SEBottleneck", "SEResNetBottleneck",
                    "SEResNeXtBottleneck")}})
# UNet: DoubleConv_k's two convs; the full network's 1x1 Conv1d_0
_UNET = Family(fixed={"Conv1d_0": ("out_conv", _CONV)},
               indexed={"DoubleConv": ("double_convs", _CONVS)})
# VGG and the autoencoder: convs and norms in creation order, the
# decoder's flax ConvTranspose_k (kernel and bias, no Conv inside)
_CONV_STACK = Family(indexed={**_RESNET_BLOCK.indexed,
                              "ConvTranspose": ("deconvs", None)})
_SE_KINDS = set(_SENET.indexed) - set(_RESNET_BLOCK.indexed)
_LSTM_CELL = Family(fixed={
    **{"i" + g: ("input." + g, None) for g in "ifgo"},
    **{"h" + g: ("hidden." + g, None) for g in "ifgo"}})
_SIMPLE_CELL = Family(fixed={"i": ("input", None), "h": ("hidden", None)})
_ATTENTION = Family(fixed={
    name: (name, None)
    for name in ("q_linear", "k_linear", "v_linear", "joint_linear")})
_BLOCK = Family(fixed={"MultiHeadAttention_0": ("attention", _ATTENTION)},
                indexed={"LayerNorm": ("norms", None),
                         "Dense": ("dense", None)})
_TRANSFORMER = Family(indexed={"Block": ("blocks", _BLOCK)})
_LEAF = {"kernel": "weight", "scale": "weight", "bias": "bias"}


# PPNet's add-on stack: flax Convs (1,) named in creation order
_ADD_ON = Family(indexed={"Conv": ("convs", None)})


def _network(backbone, dense_chain):
    dense = ({} if dense_chain else {"Dense_0": ("head", None)})
    return Family(
        fixed={"breath_block": ("breath_block", backbone),
               "OptimizedLSTMCell_0": ("lstm", _LSTM_CELL),
               "OptimizedLSTMCell_1": ("sequence_lstm", _LSTM_CELL),
               "SimpleCell_0": ("rnn", _SIMPLE_CELL),
               "Transformer_0": ("transformer", _TRANSFORMER),
               "add_on_layers": ("add_on_layers", _ADD_ON),
               "last_layer": ("last_layer", None),
               "linear_intermediate": ("linear_intermediate", None),
               "linear_final": ("linear_final", None), **dense},
        indexed={"Dense": ("layers", None)} if dense_chain else {})


def _root_family(paths):
    """The family of the tree's top level, from the names it holds."""
    names = {name for path in paths for name in path[:-1]}
    kinds = {n.rpartition("_")[0] for n in names}
    if kinds & {"BasicBlock", "Bottleneck"}:
        backbone = _RESNET
    elif kinds & _SE_KINDS:
        backbone = _SENET
    elif "DenseLayer2D" in kinds:
        backbone = _DENSENET_2D
    elif "DenseLayer" in kinds:
        backbone = _DENSENET
    elif "DoubleConv" in kinds:
        backbone = _UNET
    else:
        backbone = _CONV_STACK
    top = {path[0] for path in paths}
    if not top & {"breath_block", "OptimizedLSTMCell_0", "SimpleCell_0",
                  "Dense_0", "Transformer_0", "prototype_vectors",
                  "linear_final"}:
        return backbone  # a bare backbone tree
    return _network(backbone, "Dense_1" in top)


def _port_key(path, family):
    if path == ("prototype_vectors",):  # PPNet's (P, C, K), as it is
        return path[0]
    *modules, leaf = path
    out = []
    for name in modules:
        kind, _, index = name.rpartition("_")
        if family is not None and name in family.fixed:
            attr, family = family.fixed[name]
            out += [attr] if attr else []
        elif family is not None and kind in family.indexed:
            attr, family = family.indexed[kind]
            out += [attr, index]
        else:
            raise KeyError("no port counterpart for flax param {}".format(
                "/".join(path)))
    if leaf not in _LEAF:
        raise KeyError("unknown flax leaf {}".format("/".join(path)))
    return ".".join(out + [_LEAF[leaf]])


def _flatten(tree, prefix=()):
    for key, value in tree.items():
        if isinstance(value, Mapping):
            yield from _flatten(value, prefix + (key,))
        else:
            yield prefix + (key,), value


def transplant(params):
    """flax params (nested, or flat with "/"-joined keys) -> state_dict
    of float32 CPU tensors, ready for ``load_state_dict``."""
    if any(isinstance(v, Mapping) for v in params.values()):
        items = list(_flatten(params))
    else:
        items = [(tuple(k.split("/")), v) for k, v in params.items()]
    family = _root_family([path for path, _ in items])
    state = {}
    for path, value in items:
        value = np.asarray(value, np.float32)
        if path[-1] == "kernel":
            # (..., in, out) -> (out, in, ...)
            value = np.transpose(
                value, (value.ndim - 1, value.ndim - 2)
                + tuple(range(value.ndim - 2)))
        state[_port_key(path, family)] = torch.tensor(
            np.ascontiguousarray(value))
    return state


def _find_trace(opt_state):
    """The momentum ``trace`` tree inside an optax state: the first node
    (depth first through tuples) with a mapping ``trace`` field, as
    ``optax.trace``'s ``TraceState`` has."""
    trace = getattr(opt_state, "trace", None)
    if isinstance(trace, Mapping):
        return trace
    if isinstance(opt_state, tuple):
        for sub in opt_state:
            found = _find_trace(sub)
            if found is not None:
                return found
    return None


def load_sgd_momentum(optimizer, model, opt_state):
    """Carry the momentum of the JAX package's optimizer (the ``trace``
    of ``optax.sgd(momentum=0.9, nesterov=True)`` inside an optax chain
    state) into a ``torch.optim.SGD`` over ``model``'s params, as its
    ``momentum_buffer``s, so a step continues that run."""
    trace = _find_trace(opt_state)
    if trace is None:
        raise ValueError("no optax trace (momentum) in the optimizer state")
    buffers = transplant(trace)
    params = dict(model.named_parameters())
    if buffers.keys() != params.keys():
        raise KeyError("momentum and params differ: {}".format(
            sorted(set(buffers) ^ set(params))))
    for name, p in params.items():
        optimizer.state[p]["momentum_buffer"] = buffers[name].to(p.device)
    return optimizer
