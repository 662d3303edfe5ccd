"""Network registries: base backbones and composite-network specs.

Counterpart of ``deepards_tpu/models/registry.py``, with every entry of
the JAX package's two registries: the densenet, resnet, vgg, senet, unet
and autoencoder-encoder backbones (1D) and the densenet 2D and 2x1d
backbones; the 1D heads (``cnn_linear`` and its variants,
``cnn_regressor``, ``metadata_only``, ``autoencoder``), the recurrent and
transformer networks, the nested whole-patient networks, ``protopnet``,
the siamese networks and ``siamese_pretrained``, and the 2D networks over
breath images (``cnn_linear_2d``/``_2x1d``, ``protopnet_2d`` and the
row-band detectors).  ``conf`` is a mapping of configuration keys
(``base_network``, ``bn_scope``, ``initial_planes``, ...).

Where the JAX package's entry cannot be built the port refuses it by
name: ``autoencoder`` reconstructs its input with the full
``AutoencoderCNN``, so it is built over ``basic_cnn_ae`` only (the JAX
registry gives it the encoder, whose output cannot take the input's
shape), and ``protopnet`` needs a backbone with ``conv_info`` (a senet
raises, as the JAX one does).
"""
from dataclasses import dataclass
from typing import Callable

from deepards_tpu_torch.models import (
    autoencoder_cnn,
    densenet1d,
    densenet2d,
    detection2d,
    heads,
    nested,
    protopnet1d,
    protopnet2d,
    recurrent,
    resnet1d,
    senet1d,
    siamese,
    unet1d,
    vgg1d,
)


def _densenet_ctor(name):
    return lambda conf, in_channels: getattr(densenet1d, name)(
        in_channels=in_channels)


def _resnet_ctor(name):
    """ResNet backbones read the resnet options of the configuration
    (reference: train_ards_detector.py:389-394)."""
    return lambda conf, in_channels: getattr(resnet1d, name)(
        initial_planes=conf.get("initial_planes", 64) or 64,
        first_pool_type=conf.get("resnet_first_pool_type", "max") or "max",
        double_conv_first=bool(conf.get("resnet_double_conv")),
        in_channels=in_channels)


BASE_NETWORKS = {
    name: _densenet_ctor(name)
    for name in ("densenet18", "densenet121", "densenet161", "densenet169",
                 "densenet201")
}
BASE_NETWORKS.update({
    name: _resnet_ctor(name)
    for name in ("resnet18", "resnet34", "resnet50", "resnet101",
                 "resnet152")
})


def _densenet2d_ctor(name):
    """The 2D backbones read ``block_kernel_size``; ``in_channels`` is the
    image's C."""
    return lambda conf, in_channels: getattr(densenet2d, name)(
        block_kernel_size=conf.get("block_kernel_size", 3) or 3,
        in_channels=in_channels)


BASE_NETWORKS.update({
    name: _densenet2d_ctor(name)
    for name in ("densenet18_2d", "densenet121_2d", "densenet18_2x1d")
})



def _plain_ctor(module, name):
    return lambda conf, in_channels: getattr(module, name)(
        in_channels=in_channels)


BASE_NETWORKS.update({
    name: _plain_ctor(vgg1d, name)
    for name in ("vgg11", "vgg11_bn", "vgg13", "vgg13_bn")
})
BASE_NETWORKS.update({
    name: _plain_ctor(senet1d, name)
    for name in ("senet18", "senet154", "se_resnet18", "se_resnet50",
                 "se_resnet101", "se_resnet152", "se_resnext50_32x4d",
                 "se_resnext101_32x4d")
})
BASE_NETWORKS["unet"] = _plain_ctor(unet1d, "UNet1DEncoder")
BASE_NETWORKS["basic_cnn_ae"] = _plain_ctor(autoencoder_cnn,
                                            "AutoencoderCNNEncoder")


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
    # per_sample|per_breath|regression|autoencoder
    target_mode: str = "per_sample"
    # classifier|regressor|detector|autoencoder|siamese
    kind: str = "classifier"
    expand_obs_idx: bool = False  # per-breath heads repeat an index S times
    uses_metadata: bool = False  # reads the metadata input
    stateful_lstm: bool = False  # carries its LSTM state when unshuffled
    super_batch: bool = False  # whole-patient super batches (NestedTrainer)
    eval_dropout_off: bool = False  # eval runs with dropout off
    trainer: str = "standard"  # standard|protopnet|siamese
    two_dim: bool = False  # over ImgARDSDataset images (N, C, H, W)


def _bn_scope(conf):
    """'sequence' gives each sample's windows their own normalization
    statistics; the default 'batch' normalizes all B*S windows together."""
    return conf.get("bn_scope") or "batch"


def n_bm_features(conf):
    """Regression outputs by dataset type
    (reference: train_ards_detector.py:99-104)."""
    dt = conf.get("dataset_type")
    if dt == "padded_breath_by_breath_with_limited_bm_target":
        return 3
    if dt == "padded_breath_by_breath_with_experimental_bm_target":
        return 7
    return 9


def _simple(name, cls, **kw):
    return NetworkSpec(
        name, lambda conf, bb, s, m=0: cls(bb, bn_scope=_bn_scope(conf)),
        **kw)


def _hidden_units(conf):
    return conf.get("time_series_hidden_units", 16) or 16


def _lstm_only(cls):
    """The networks without a backbone: ``bb`` is built all the same, as
    the JAX trainer builds it, and carries the cache's C."""
    return lambda conf, bb, s, m=0: cls(
        s, in_channels=bb.in_channels, lstm_hidden_units=_hidden_units(conf))


def _nested(name, build):
    return NetworkSpec(name, build, target_mode="per_breath",
                       expand_obs_idx=True, super_batch=True)


def _lstm_options(conf, m):
    return dict(
        lstm_hidden_units=_hidden_units(conf), metadata_features=m,
        bm_to_linear=bool(conf.get("bm_to_linear")), bn_scope=_bn_scope(conf))


NETWORK_MAP = {
    "cnn_linear": NetworkSpec(
        "cnn_linear",
        lambda conf, bb, s, m=0: heads.CNNLinearNetwork(
            breath_block=bb, n_sub_batches=s, metadata_features=m,
            bn_scope=_bn_scope(conf),
        ),
        uses_metadata=True,
    ),
    "cnn_double_linear": NetworkSpec(
        "cnn_double_linear",
        lambda conf, bb, s, m=0: heads.CNNDoubleLinearNetwork(
            breath_block=bb, n_sub_batches=s, metadata_features=m,
            bn_scope=_bn_scope(conf),
        ),
        uses_metadata=True,
    ),
    "cnn_single_breath_linear": _simple(
        "cnn_single_breath_linear", heads.CNNSingleBreathLinearNetwork,
        target_mode="per_breath", expand_obs_idx=True),
    "cnn_linear_to_mean": _simple("cnn_linear_to_mean",
                                  heads.CNNLinearToMean),
    "cnn_linear_compr_to_rf": _simple("cnn_linear_compr_to_rf",
                                      heads.CNNLinearComprToRF),
    "cnn_regressor": NetworkSpec(
        "cnn_regressor",
        lambda conf, bb, s, m=0: heads.CNNRegressor(
            breath_block=bb, n_sub_batches=s,
            n_outputs=n_bm_features(conf), bn_scope=_bn_scope(conf),
        ),
        target_mode="regression",
        kind="regressor",
    ),
    "metadata_only": NetworkSpec(
        "metadata_only",
        lambda conf, bb, s, m=0: heads.MetadataOnlyNetwork(),
        uses_metadata=True,
    ),
    "cnn_lstm": NetworkSpec(
        "cnn_lstm",
        lambda conf, bb, s, m=0: recurrent.CNNLSTMNetwork(
            breath_block=bb, **_lstm_options(conf, m)),
        target_mode="per_breath",
        expand_obs_idx=True,
        uses_metadata=True,
        stateful_lstm=True,
        eval_dropout_off=True,
    ),
    "cnn_lstm_double_linear": NetworkSpec(
        "cnn_lstm_double_linear",
        lambda conf, bb, s, m=0: recurrent.CNNLSTMDoubleLinearNetwork(
            breath_block=bb, n_sub_batches=s, **_lstm_options(conf, m)),
        uses_metadata=True,
    ),
    "lstm_only": NetworkSpec(
        "lstm_only", _lstm_only(recurrent.LSTMOnlyNetwork)),
    "lstm_only_with_packing": NetworkSpec(
        "lstm_only_with_packing", _lstm_only(recurrent.LSTMOnlyWithPacking)),
    "double_lstm": NetworkSpec(
        "double_lstm", _lstm_only(recurrent.DoubleLSTMNetwork)),
    "cnn_transformer": NetworkSpec(
        "cnn_transformer",
        lambda conf, bb, s, m=0: recurrent.CNNTransformerNetwork(
            breath_block=bb, hidden_units=_hidden_units(conf),
            num_blocks=conf.get("transformer_blocks", 2) or 2,
            metadata_features=m,
            bm_to_linear=bool(conf.get("bm_to_linear")),
            bn_scope=_bn_scope(conf)),
        target_mode="per_breath",
        expand_obs_idx=True,
        uses_metadata=True,
    ),
    "cnn_to_nested_rnn": _nested(
        "cnn_to_nested_rnn",
        lambda conf, bb, s, m=0: nested.CNNToNestedRNNNetwork(bb)),
    "cnn_to_nested_lstm": _nested(
        "cnn_to_nested_lstm",
        lambda conf, bb, s, m=0: nested.CNNToNestedLSTMNetwork(bb)),
    "cnn_to_nested_transformer": _nested(
        "cnn_to_nested_transformer",
        lambda conf, bb, s, m=0: nested.CNNToNestedTransformerNetwork(
            bb, transformer_blocks=conf.get("transformer_blocks", 2) or 2)),
    "protopnet": NetworkSpec(
        "protopnet",
        lambda conf, bb, s, m=0: protopnet1d.construct_ppnet(
            _with_conv_info(bb), sub_batch_size=s,
            n_prototypes=conf.get("n_prototypes", 10) or 10,
            incorrect_strength=conf.get("incorrect_strength", -0.5) or -0.5,
            average_linear=bool(conf.get("average_linear_layer"))),
        # its trainer evaluates with dropout off; so do serve and predict
        eval_dropout_off=True,
        trainer="protopnet",
    ),
    "cnn_linear_2d": NetworkSpec(
        "cnn_linear_2d",
        lambda conf, bb, s, m=0: densenet2d.CNNLinearNetwork2D(bb),
        two_dim=True),
    "cnn_linear_2x1d": NetworkSpec(
        "cnn_linear_2x1d",
        lambda conf, bb, s, m=0: densenet2d.CNNLinearNetwork2D(bb),
        two_dim=True),
    "protopnet_2d": NetworkSpec(
        "protopnet_2d",
        lambda conf, bb, s, m=0: protopnet2d.construct_ppnet_2d(
            bb, n_prototypes=conf.get("n_prototypes", 10) or 10,
            incorrect_strength=conf.get("incorrect_strength", -0.5) or -0.5),
        eval_dropout_off=True,
        trainer="protopnet",
        two_dim=True),
    # the reference's three detectors (train_ards_detector.py:118) are one
    # row-band detector over their backbones, as in the JAX package
    **{name: NetworkSpec(
        name,
        lambda conf, bb, s, m=0: detection2d.RowBandDetector(bb),
        kind="detector",
        two_dim=True)
       for name in ("retinanet_2d", "retinanet_2x1d", "faster_rcnn_2d")},
}


def _with_conv_info(bb):
    """``bb``, whose ``conv_info`` ProtoPNet's receptive fields read:
    raises as the backbone's own does (SENet's ``NotImplementedError``),
    or names a backbone that has none."""
    if not hasattr(bb, "conv_info"):
        raise ValueError("protopnet reads its backbone's conv_info, which "
                         "{} has not".format(type(bb).__name__))
    bb.conv_info()
    return bb


def _autoencoder(conf, bb, s, m=0):
    """The full ``AutoencoderCNN`` over ``basic_cnn_ae``'s input channels
    (the reference's ``AutoencoderNetwork``); another base network is
    refused by name."""
    if conf.get("base_network") != "basic_cnn_ae":
        raise ValueError(
            "autoencoder reconstructs its input with AutoencoderCNN: "
            "--base-network basic_cnn_ae, not {}".format(
                conf.get("base_network")))
    return heads.AutoencoderNetwork(
        autoencoder_cnn.AutoencoderCNN(in_channels=bb.in_channels))


NETWORK_MAP.update({
    "autoencoder": NetworkSpec("autoencoder", _autoencoder,
                               target_mode="autoencoder",
                               kind="autoencoder"),
    # the networks of the siamese trainer
    **{name: NetworkSpec(name, build, kind="siamese", trainer="siamese")
       for name, build in (
           ("siamese_cnn_linear",
            lambda conf, bb, s, m=0: siamese.SiameseCNNLinearNetwork(
                bb, s, bn_scope=_bn_scope(conf))),
           ("siamese_cnn_lstm",
            lambda conf, bb, s, m=0: siamese.SiameseCNNLSTMNetwork(
                bb, s, _hidden_units(conf), _bn_scope(conf))),
           ("siamese_cnn_transformer",
            lambda conf, bb, s, m=0: siamese.SiameseCNNTransformerNetwork(
                bb, s, _hidden_units(conf), _bn_scope(conf))))},
    "siamese_pretrained": NetworkSpec(
        "siamese_pretrained",
        lambda conf, bb, s, m=0: siamese.SiameseARDSClassifier(
            bb, s, time_layer=conf.get("siamese_time_layer") or "none",
            hidden_units=_hidden_units(conf), bn_scope=_bn_scope(conf))),
})


def two_dim_base_network(spec, base):
    """The backbone a 2D network trains: ``base`` with the suffix of its
    family, ``_2x1d`` for a ``*_2x1d`` network, else ``_2d``, unless it
    has one (``deepards_tpu/train/loop.py:242-247``)."""
    if spec.name.endswith("_2x1d"):
        return base if "2x1d" in base else base + "_2x1d"
    return base if "_2d" in base else base + "_2d"


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
