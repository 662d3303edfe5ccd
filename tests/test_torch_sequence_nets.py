"""The sequence networks of the standard trainer and the four 1D heads
against the JAX package: lstm_only, lstm_only_with_packing, double_lstm,
cnn_transformer (``deepards_tpu/models/recurrent.py``),
cnn_double_linear, cnn_single_breath_linear, cnn_linear_to_mean and
cnn_linear_compr_to_rf (``deepards_tpu/models/heads.py``).

Parameters are numpy draws in the flax trees' shapes, carried over with
``transplant`` (``test_torch_configs_2_3_4.random_params``); the backbone
is a narrow resnet18 (``initial_planes`` 8), S = 4, float32, dropout off.
Each forward's logits within 1e-5; one train step of each (Nesterov SGD
with the 0.01 clamp, a pad row) with its loss and every param within
1e-5; the packing variant's lengths, ``--with-fft``'s (B*S, L, C)
reshape through lstm_only, and the lower median of cnn_linear_compr_to_rf
where it and the mean of the middle two differ.
"""
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_configs_2_3_4 import (
    EXPERIMENTS,
    assert_round_trip,
    assert_train_steps_match_jax,
    jit_apply,
    random_params,
    windows,
)

import chip_smoke
from deepards_tpu.models import heads as jheads
from deepards_tpu.models import recurrent as jrecurrent
from deepards_tpu.models import registry as jregistry
from deepards_tpu.models import resnet1d as jresnet
from deepards_tpu_torch.cli.train import build_parser
from deepards_tpu_torch.config.config import Configuration
from deepards_tpu_torch.models import heads, recurrent, resnet1d
from deepards_tpu_torch.models.registry import (
    NETWORK_MAP,
    get_base_network,
    get_network_spec,
)

# parallel test workers share the cores: one torch thread each
torch.set_num_threads(1)

B, S, L, PLANES, M = 3, 4, 224, 8, 9


def _t(x):
    return torch.from_numpy(np.asarray(x))


def _jbb():
    return jresnet.resnet18(initial_planes=PLANES)


def _bb(channels=1):
    return resnet1d.resnet18(initial_planes=PLANES, in_channels=channels)


# name -> (flax model, port model, target_mode, metadata features)
NETWORKS = {
    "lstm_only": lambda: (jrecurrent.LSTMOnlyNetwork(),
                          recurrent.LSTMOnlyNetwork(S), "per_sample", 0),
    "lstm_only_with_packing": lambda: (
        jrecurrent.LSTMOnlyWithPacking(), recurrent.LSTMOnlyWithPacking(S),
        "per_sample", 0),
    "double_lstm": lambda: (jrecurrent.DoubleLSTMNetwork(),
                            recurrent.DoubleLSTMNetwork(S), "per_sample", 0),
    "cnn_transformer": lambda: (
        jrecurrent.CNNTransformerNetwork(breath_block=_jbb()),
        recurrent.CNNTransformerNetwork(_bb()), "per_breath", 0),
    "cnn_transformer_metadata": lambda: (
        jrecurrent.CNNTransformerNetwork(breath_block=_jbb(),
                                         metadata_features=M),
        recurrent.CNNTransformerNetwork(_bb(), metadata_features=M),
        "per_breath", M),
    "cnn_transformer_bm_to_linear_sequence": lambda: (
        jrecurrent.CNNTransformerNetwork(
            breath_block=_jbb(), metadata_features=M, bm_to_linear=True,
            bn_scope="sequence"),
        recurrent.CNNTransformerNetwork(_bb(), metadata_features=M,
                                        bm_to_linear=True,
                                        bn_scope="sequence"),
        "per_breath", M),
    "cnn_double_linear": lambda: (
        jheads.CNNDoubleLinearNetwork(breath_block=_jbb()),
        heads.CNNDoubleLinearNetwork(_bb(), S), "per_sample", 0),
    "cnn_double_linear_metadata": lambda: (
        jheads.CNNDoubleLinearNetwork(breath_block=_jbb(),
                                      metadata_features=M),
        heads.CNNDoubleLinearNetwork(_bb(), S, metadata_features=M),
        "per_sample", M),
    "cnn_single_breath_linear": lambda: (
        jheads.CNNSingleBreathLinearNetwork(breath_block=_jbb()),
        heads.CNNSingleBreathLinearNetwork(_bb()), "per_breath", 0),
    "cnn_linear_to_mean": lambda: (
        jheads.CNNLinearToMean(breath_block=_jbb(), bn_scope="sequence"),
        heads.CNNLinearToMean(_bb(), bn_scope="sequence"), "per_sample", 0),
    "cnn_linear_compr_to_rf": lambda: (
        jheads.CNNLinearComprToRF(breath_block=_jbb()),
        heads.CNNLinearComprToRF(_bb()), "per_sample", 0),
}


def _forward_pair(name, x, meta=None, seed=1):
    jmodel, model, _, m = NETWORKS[name]()
    jmeta = None if meta is None else jnp.asarray(meta)
    params = random_params(jmodel, seed, jnp.asarray(x), jmeta, True)
    want = jit_apply(jmodel, True)(params, jnp.asarray(x), None, jmeta)
    assert_round_trip(params, model)
    with torch.no_grad():
        got = model(_t(x), True, None, None if meta is None else _t(meta))
    return got.numpy(), np.asarray(want), model


@pytest.mark.parametrize("name", sorted(NETWORKS))
def test_forward_matches_flax(name):
    _, _, target_mode, m = NETWORKS[name]()
    x = windows(0, (B, S, 1, L)) * 3
    meta = windows(2, (B, S, M)) if m else None
    got, want, _ = _forward_pair(name, x, meta)
    assert got.shape == ((B, S, 2) if target_mode == "per_breath"
                         else (B, 2))
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=0)


TRAINED = ["lstm_only", "lstm_only_with_packing", "double_lstm",
           "cnn_transformer", "cnn_double_linear", "cnn_single_breath_linear",
           "cnn_linear_to_mean", "cnn_linear_compr_to_rf"]


@pytest.mark.parametrize("name", TRAINED)
def test_train_step_matches_jax(name):
    jmodel, model, target_mode, _ = NETWORKS[name]()
    assert_train_steps_match_jax(jmodel, model, S, B + 1, "sgd", target_mode,
                                 steps=1, loss_atol=1e-5)


def test_with_fft_reshape_through_lstm_only():
    """C = 2: ``x.reshape(b * s, l, c)`` reads the two channels laid end
    to end two samples a step (a transpose would give other outputs);
    the forward and a train step match the JAX network."""
    x = windows(3, (B, S, 2, L))
    jmodel = jrecurrent.LSTMOnlyNetwork()
    params = random_params(jmodel, 4, jnp.asarray(x), None, True)
    want = jit_apply(jmodel, True)(params, jnp.asarray(x), None, None)
    model = recurrent.LSTMOnlyNetwork(S, in_channels=2)
    assert_round_trip(params, model)
    with torch.no_grad():
        got = model(_t(x), True).numpy()
        transposed = model.layers[1](model.layers[0](model.lstm(
            _t(x).reshape(B * S, 2, L).transpose(1, 2))[1].reshape(
                B, S, -1)).reshape(B, -1)).numpy()
    np.testing.assert_allclose(got, np.asarray(want), atol=1e-5, rtol=0)
    assert np.abs(transposed - got).max() > 1e-3
    assert_train_steps_match_jax(jrecurrent.LSTMOnlyNetwork(),
                                 recurrent.LSTMOnlyNetwork(S, in_channels=2),
                                 S, B, "sgd", "per_sample", steps=1,
                                 loss_atol=1e-5, channels=2)


def test_packing_lengths_match_flax():
    """Windows that end in zeros at sample 100, that start with a zero
    (length L), and that have none: the outputs from each length on are
    zero, and the network matches the JAX one."""
    x = windows(5, (B, S, 1, L)) * 3
    x[0, 1, 0, 100:] = 0.0
    x[1, 2, 0, 0] = 0.0
    x[2, 0, 0, 37:] = 0.0
    got, want, model = _forward_pair("lstm_only_with_packing", x)
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=0)
    with torch.no_grad():
        out = model.sample_outputs(_t(x)).reshape(B, S, L, -1)
    assert torch.all(out[0, 1, 101:] == 0) and torch.any(out[0, 1, 100] != 0)
    assert torch.all(out[2, 0, 38:] == 0) and torch.any(out[2, 0, 37] != 0)
    assert torch.all(out[1, 2].abs().sum(-1) > 0)  # a zero at 0: length L


def test_compr_to_rf_takes_the_lower_median():
    """S = 4: the lower of the two middle features, as the JAX head (and
    the reference's ``torch.median``) takes it, not their mean."""
    x = windows(6, (B, S, 1, L)) * 3
    got, want, model = _forward_pair("cnn_linear_compr_to_rf", x)
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=0)
    with torch.no_grad():
        feats = model.features(_t(x), True, None)
        srt = torch.sort(feats, dim=1).values
        lower = model.head(srt[:, 1]).numpy()
        midpoint = model.head((srt[:, 1] + srt[:, 2]) / 2).numpy()
    np.testing.assert_allclose(got, lower, atol=1e-6, rtol=0)
    assert np.abs(midpoint - got).max() > 1e-3


SPEC_FIELDS = ("target_mode", "kind", "expand_obs_idx", "uses_metadata",
               "stateful_lstm", "super_batch", "eval_dropout_off", "trainer")
NEW = ("lstm_only", "lstm_only_with_packing", "double_lstm",
       "cnn_transformer", "cnn_double_linear", "cnn_single_breath_linear",
       "cnn_linear_to_mean", "cnn_linear_compr_to_rf", "cnn_to_nested_rnn",
       "cnn_to_nested_lstm", "cnn_to_nested_transformer")


@pytest.mark.parametrize("name", NEW)
def test_registry_spec_matches_jax(name):
    """Each new network is ported with the JAX package's spec fields, and
    builds with the configuration's options (hidden units, blocks)."""
    assert name in NETWORK_MAP
    spec, want = get_network_spec(name), jregistry.get_network_spec(name)
    for field in SPEC_FIELDS:
        assert getattr(spec, field) == getattr(want, field), field
    conf = {"base_network": "densenet18", "time_series_hidden_units": 8,
            "transformer_blocks": 3}
    model = spec.build(conf, get_base_network(conf, 2), 20, 0)
    if name.startswith(("lstm_only", "double_lstm")):
        assert model.lstm.hidden_size == 8
        assert model.lstm.input["i"].in_features == 2  # the cache's C
    if "transformer" in name:
        assert len(model.transformer.blocks) == 3


@pytest.mark.parametrize("name,yml", [
    ("lstm_only", "lstm_only_experiment_benchmark.yml"),
    ("lstm_only_with_packing", "lstm_only_with_packing.yml"),
])
def test_chip_smoke_flags_give_the_lstm_only_configs(name, yml):
    """chip_smoke.py's flags give the generated experiment files'
    configurations.  lstm_only_with_packing.yml spells epochs ``pochs``:
    both packages' readers keep that key, which nothing reads, and train
    the default 10 epochs, as the flags do."""
    def conf(argv):
        out = Configuration(build_parser().parse_args(argv)).conf
        out.pop("config_override")
        return out

    got = conf(chip_smoke.CONFIG_FLAGS[name])
    want = conf(["-co", os.path.join(EXPERIMENTS, "generated", yml)])
    assert want.pop("pochs", 10) == 10 and want["epochs"] == 10
    for key in set(got) | set(want):
        a, b = got.get(key), want.get(key)
        if isinstance(a, bool) or isinstance(b, bool):
            assert bool(a) == bool(b), key
        else:
            assert a == b, key
