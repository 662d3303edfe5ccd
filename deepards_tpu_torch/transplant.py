"""flax parameter tree -> the port's ``state_dict``.

The JAX package's densenet/cnn_linear params are a nested dict

    {"breath_block": {"Conv1d_0": {"Conv_0": {"kernel"}}, "BatchStatNorm_0",
                      "DenseLayer_0".., "Transition_0".., "BatchStatNorm_1"},
     "Dense_0": {"kernel", "bias"}}

(the same tree under either ``bn_scope``).  ``transplant`` accepts it as
nested dicts of arrays, or flat with "a/b/c" keys as
``flax.traverse_util.flatten_dict(params, sep="/")`` gives and as
``np.savez`` of that flat dict stores it.  A bare backbone tree (no
"breath_block" level) maps onto a ``DenseNet1D``.

Layouts: conv kernels go from (K, Cin, Cout) to (Cout, Cin, K), Dense
kernels (in, out) are transposed to (out, in), norm scale/bias become
weight/bias.  ``load_sgd_momentum`` maps the momentum of an optax SGD
state the same way, into a torch SGD's state.
"""
from collections.abc import Mapping

import numpy as np
import torch

# flax module name -> port attribute, by the module that holds it
_BACKBONE = {"Conv1d_0": "conv0", "BatchStatNorm_0": "norm0",
             "BatchStatNorm_1": "norm5"}
_DENSE_LAYER = {"BatchStatNorm_0": "norm1", "Conv1d_0": "conv1",
                "BatchStatNorm_1": "norm2", "Conv1d_1": "conv2"}
_TRANSITION = {"BatchStatNorm_0": "norm", "Conv1d_0": "conv"}
_LEAF = {"kernel": "weight", "scale": "weight", "bias": "bias"}


def _flatten(tree, prefix=()):
    for key, value in tree.items():
        if isinstance(value, Mapping):
            yield from _flatten(value, prefix + (key,))
        else:
            yield prefix + (key,), value


def _port_key(path):
    *modules, leaf = path
    out = []
    table = _BACKBONE
    for name in modules:
        kind, _, index = name.rpartition("_")
        if name == "Conv_0":  # flax's Conv inside the Conv1d wrapper
            continue
        if name == "breath_block":
            out.append(name)
        elif name == "Dense_0":
            out.append("head")
        elif kind == "DenseLayer":
            out += ["dense_layers", index]
            table = _DENSE_LAYER
        elif kind == "Transition":
            out += ["transitions", index]
            table = _TRANSITION
        elif name in table:
            out.append(table[name])
        else:
            raise KeyError("no port counterpart for flax param {}".format(
                "/".join(path)))
    if leaf not in _LEAF:
        raise KeyError("unknown flax leaf {}".format("/".join(path)))
    return ".".join(out + [_LEAF[leaf]])


def transplant(params):
    """flax params (nested, or flat with "/"-joined keys) -> state_dict
    of float32 CPU tensors, ready for ``load_state_dict``."""
    if any(isinstance(v, Mapping) for v in params.values()):
        items = _flatten(params)
    else:
        items = ((tuple(k.split("/")), v) for k, v in params.items())
    state = {}
    for path, value in items:
        value = np.asarray(value, np.float32)
        if path[-1] == "kernel":
            value = np.transpose(value, tuple(range(value.ndim))[::-1])
        state[_port_key(path)] = torch.tensor(np.ascontiguousarray(value))
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
