"""Network registries: base backbones and composite-network specs.

Counterpart of ``deepards_tpu/models/registry.py``, holding the entries
the port has so far: the densenet backbones and ``cnn_linear``.  ``conf``
is a mapping of configuration keys (``base_network``, ``bn_scope``).
"""
from dataclasses import dataclass
from typing import Callable

from deepards_tpu_torch.models import densenet1d, heads


def _densenet_ctor(name):
    return lambda conf, in_channels: getattr(densenet1d, name)(
        in_channels=in_channels)


BASE_NETWORKS = {
    name: _densenet_ctor(name)
    for name in ("densenet18", "densenet121", "densenet161", "densenet169",
                 "densenet201")
}


def get_base_network(conf, in_channels=1):
    """The backbone ``conf`` names, over ``in_channels`` input channels
    (the window cache's C)."""
    name = conf["base_network"]
    if name not in BASE_NETWORKS:
        raise ValueError(
            "unknown base network: {} (have: {})".format(
                name, sorted(BASE_NETWORKS)
            )
        )
    return BASE_NETWORKS[name](conf, in_channels)


@dataclass
class NetworkSpec:
    """How the trainer treats a network (the JAX package's fields)."""

    name: str
    # (conf, base_network, n_sub_batches[, metadata_features]) -> module
    build: Callable
    target_mode: str = "per_sample"  # per_sample|per_breath|regression|autoencoder
    kind: str = "classifier"  # classifier|regressor|autoencoder|siamese|detector
    expand_obs_idx: bool = False  # per-breath heads repeat an index S times
    eval_dropout_off: bool = False  # eval runs with dropout off
    trainer: str = "standard"  # standard|protopnet|siamese


def _bn_scope(conf):
    """'sequence' gives each sample's windows their own normalization
    statistics; the default 'batch' normalizes all B*S windows together."""
    return conf.get("bn_scope") or "batch"


NETWORK_MAP = {
    "cnn_linear": NetworkSpec(
        "cnn_linear",
        lambda conf, bb, s, m=0: heads.CNNLinearNetwork(
            breath_block=bb, n_sub_batches=s, metadata_features=m,
            bn_scope=_bn_scope(conf),
        ),
    ),
}


def get_network_spec(name):
    if name not in NETWORK_MAP:
        raise ValueError(
            "unknown network: {} (have: {})".format(name, sorted(NETWORK_MAP))
        )
    return NETWORK_MAP[name]


def metadata_features_for(conf):
    """Metadata features per window the head concatenates: 9 flow-time
    features for ``padded_breath_by_breath_with_flow_time_features``, else
    none (the head then ignores a cache's metadata)
    (reference: train_ards_detector.py:106-109)."""
    if conf.get("dataset_type") == \
            "padded_breath_by_breath_with_flow_time_features":
        return 9
    return 0
