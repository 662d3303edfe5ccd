"""densenet18 and CNNLinearNetwork against the JAX package.

Both packages get the same parameters: the flax model is initialised from
a seed and its tree goes through ``deepards_tpu_torch.transplant``.
Dropout off (drop_rate 0, deterministic) on both sides; windows of
L = 224, which the 7-wide final pool needs.  Tolerance atol/rtol 1e-4 on
logits and features (f32 convolutions in another summation order).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import traverse_util

from deepards_tpu.models import densenet1d as jdn
from deepards_tpu.models import heads as jheads
from deepards_tpu.models.layers import bn_row_mask as jax_bn_row_mask
from deepards_tpu_torch.models import densenet1d, heads
from deepards_tpu_torch.models.layers import bn_row_mask
from deepards_tpu_torch.models.registry import (
    get_base_network,
    get_network_spec,
)
from deepards_tpu_torch.transplant import transplant

# parallel test workers share the cores: one torch thread each
torch.set_num_threads(1)

TOL = dict(atol=1e-4, rtol=1e-4)
B, S, L = 2, 4, 224


def _np_tree(params):
    return jax.tree_util.tree_map(np.asarray, params)


@pytest.fixture(scope="module")
def backbone():
    """(flax densenet18 params, port densenet18 with them), dropout off."""
    x = jnp.zeros((B * S, 1, L), jnp.float32)
    params = jdn.densenet18(drop_rate=0.0).init(
        jax.random.PRNGKey(0), x, True)["params"]
    model = densenet1d.densenet18(drop_rate=0.0)
    model.load_state_dict(transplant(_np_tree(params)))
    return params, model


@pytest.fixture(scope="module")
def cnn_params():
    x = jnp.zeros((B, S, 1, L), jnp.float32)
    model = jheads.CNNLinearNetwork(breath_block=jdn.densenet18(drop_rate=0.0))
    return model.init(jax.random.PRNGKey(1), x, None, True)["params"]


def _port_cnn(params, bn_scope):
    model = heads.CNNLinearNetwork(
        densenet1d.densenet18(drop_rate=0.0), S, bn_scope=bn_scope)
    model.load_state_dict(transplant(_np_tree(params)))
    return model


def _windows(seed, n=B):
    return np.random.default_rng(seed).normal(
        size=(n, S, 1, L)).astype(np.float32)


def test_densenet18_features_match_flax(backbone):
    params, model = backbone
    x = _windows(0).reshape(B * S, 1, L)
    jmodel = jdn.densenet18(drop_rate=0.0)
    want = np.asarray(jmodel.apply({"params": params}, jnp.asarray(x), True))
    with torch.no_grad():
        got = model(torch.from_numpy(x), True).numpy()
    assert got.shape == (B * S, 128)
    np.testing.assert_allclose(got, want, **TOL)


def test_densenet18_forward_no_pool_matches_flax(backbone):
    params, model = backbone
    x = _windows(1).reshape(B * S, 1, L)
    jmodel = jdn.densenet18(drop_rate=0.0)
    want = np.asarray(jmodel.apply(
        {"params": params}, jnp.asarray(x), True,
        method=jdn.DenseNet1D.forward_no_pool))
    with torch.no_grad():
        got = model.forward_no_pool(torch.from_numpy(x), True).numpy()
    # port (N, C, L') vs JAX (N, L', C)
    np.testing.assert_allclose(got, np.transpose(want, (0, 2, 1)), **TOL)


@pytest.mark.parametrize("bn_scope", ["batch", "sequence"])
def test_cnn_linear_logits_match_flax(cnn_params, bn_scope):
    x = _windows(2)
    jmodel = jheads.CNNLinearNetwork(
        breath_block=jdn.densenet18(drop_rate=0.0), bn_scope=bn_scope)
    want = np.asarray(jmodel.apply({"params": cnn_params}, jnp.asarray(x),
                                   None, True))
    with torch.no_grad():
        got = _port_cnn(cnn_params, bn_scope)(
            torch.from_numpy(x), True).numpy()
    assert got.shape == (B, 2)
    np.testing.assert_allclose(got, want, **TOL)


def test_bn_scopes_differ_for_batch_above_one(cnn_params):
    """The two scopes are not the same function when B > 1."""
    x = torch.from_numpy(_windows(3))
    with torch.no_grad():
        batch = _port_cnn(cnn_params, "batch")(x, True)
        seq = _port_cnn(cnn_params, "sequence")(x, True)
    assert (batch - seq).abs().max() > 1e-4


def test_padded_final_batch_matches_true_size_and_flax(cnn_params):
    """A padded dispatch with the row mask gives the true-size logits on
    the real rows, as the JAX package's masked dispatch does."""
    real = _windows(4, n=3)
    padded = np.concatenate([real, np.zeros((2, S, 1, L), np.float32)])
    rows = np.repeat(np.array([1, 1, 1, 0, 0], np.float32), S)
    model = _port_cnn(cnn_params, "batch")
    with torch.no_grad():
        true_size = model(torch.from_numpy(real), True).numpy()
        with bn_row_mask(torch.from_numpy(rows)):
            got = model(torch.from_numpy(padded), True).numpy()
    jmodel = jheads.CNNLinearNetwork(
        breath_block=jdn.densenet18(drop_rate=0.0))
    with jax_bn_row_mask(jnp.asarray(rows)):
        want = np.asarray(jmodel.apply({"params": cnn_params},
                                       jnp.asarray(padded), None, True))
    np.testing.assert_allclose(got[:3], true_size, atol=1e-5, rtol=1e-5)
    np.testing.assert_allclose(got[:3], want[:3], **TOL)


def test_transplant_flat_keys_equal_nested(cnn_params):
    nested = transplant(_np_tree(cnn_params))
    flat = transplant(traverse_util.flatten_dict(_np_tree(cnn_params),
                                                 sep="/"))
    assert nested.keys() == flat.keys()
    for k in nested:
        assert torch.equal(nested[k], flat[k])
    # strict load covers every parameter of the port's model
    model = _port_cnn(cnn_params, "batch")
    assert set(nested) == set(model.state_dict())
    assert nested["head.weight"].shape == (2, S * 128)
    assert nested["breath_block.conv0.weight"].shape == (64, 1, 7)


def test_transplant_rejects_unknown_param():
    with pytest.raises(KeyError, match="no port counterpart"):
        transplant({"breath_block/Mystery_0/kernel": np.zeros((1, 1, 1))})


def test_dropout_follows_generator():
    model = densenet1d.densenet18().reset_parameters(
        torch.Generator().manual_seed(0))
    x = torch.from_numpy(_windows(5).reshape(B * S, 1, L))

    def run(seed):
        with torch.no_grad():
            return model(x, False, torch.Generator().manual_seed(seed))

    assert torch.equal(run(7), run(7))
    assert not torch.equal(run(7), run(8))
    with torch.no_grad():
        off = model(x, True)
        model_no_drop = densenet1d.densenet18(drop_rate=0.0)
        model_no_drop.load_state_dict(model.state_dict())
        assert torch.equal(off, model_no_drop(x, False))


def test_registry_builds_seeded_full_width_cnn_linear():
    conf = {"base_network": "densenet18", "bn_scope": "sequence"}
    built = [
        get_network_spec("cnn_linear").build(
            conf, get_base_network(conf), 20).reset_parameters(
                torch.Generator().manual_seed(3))
        for _ in range(2)
    ]
    assert built[0].bn_scope == "sequence"
    assert built[0].breath_block.n_out_filters == 128
    for (k, v), (_, w) in zip(built[0].state_dict().items(),
                              built[1].state_dict().items()):
        assert torch.equal(v, w), k
    with pytest.raises(ValueError, match="unknown base network"):
        get_base_network({"base_network": "no_such_base_network"})
    with pytest.raises(ValueError, match="unknown network"):
        get_network_spec("no_such_network")
    twin = get_network_spec("siamese_cnn_transformer")
    assert (twin.kind, twin.trainer) == ("siamese", "siamese")
    with pytest.raises(ValueError, match="basic_cnn_ae"):
        get_network_spec("autoencoder").build(conf, get_base_network(conf),
                                              20)
