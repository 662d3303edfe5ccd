"""Network registries: base backbones and composite-network specs.

Counterpart of ``deepards_tpu/models/registry.py``, holding the entries
the port has so far: the densenet backbones and ``cnn_linear``.  ``conf``
is a mapping of configuration keys (``base_network``, ``bn_scope``).
"""
from dataclasses import dataclass
from typing import Callable

from deepards_tpu_torch.models import densenet1d, heads


def _densenet_ctor(name):
    return lambda conf: getattr(densenet1d, name)()


BASE_NETWORKS = {
    name: _densenet_ctor(name)
    for name in ("densenet18", "densenet121", "densenet161", "densenet169",
                 "densenet201")
}


def get_base_network(conf):
    name = conf["base_network"]
    if name not in BASE_NETWORKS:
        raise ValueError(
            "unknown base network: {} (have: {})".format(
                name, sorted(BASE_NETWORKS)
            )
        )
    return BASE_NETWORKS[name](conf)


@dataclass
class NetworkSpec:
    """How the trainer treats a network (the JAX package's fields)."""

    name: str
    build: Callable  # (conf, base_network, n_sub_batches) -> module
    target_mode: str = "per_sample"  # per_sample|per_breath|regression|autoencoder
    kind: str = "classifier"  # classifier|regressor|autoencoder|siamese|detector
    expand_obs_idx: bool = False  # per-breath heads repeat an index S times
    # the JAX head takes a metadata input; the port's heads do not yet
    uses_metadata: bool = False
    eval_dropout_off: bool = False  # eval runs with dropout off
    trainer: str = "standard"  # standard|protopnet|siamese


def _bn_scope(conf):
    """'sequence' gives each sample's windows their own normalization
    statistics; the default 'batch' normalizes all B*S windows together."""
    return conf.get("bn_scope") or "batch"


NETWORK_MAP = {
    "cnn_linear": NetworkSpec(
        "cnn_linear",
        lambda conf, bb, s: heads.CNNLinearNetwork(
            breath_block=bb, n_sub_batches=s, bn_scope=_bn_scope(conf),
        ),
        uses_metadata=True,
    ),
}


def get_network_spec(name):
    if name not in NETWORK_MAP:
        raise ValueError(
            "unknown network: {} (have: {})".format(name, sorted(NETWORK_MAP))
        )
    return NETWORK_MAP[name]
