"""The ResNet backbones and cnn_linear over resnet18 (benchmark config 2's
network) against the JAX package.

Both packages get the same parameters: numpy draws them from a seed into
the flax tree's shapes (``jax.eval_shape`` of ``init``, so no init is
compiled) and ``deepards_tpu_torch.transplant`` carries them over.
Narrow models (``initial_planes`` 8) at L = 224, which the final 7-wide
pool needs.  Tolerance atol/rtol 1e-4 on features and logits (f32
convolutions in another summation order).
"""
import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from flax import traverse_util

from test_torch_configs_2_3_4 import (
    assert_round_trip,
    assert_three_train_steps_match_jax,
    jit_apply,
    random_params,
    windows,
)

from deepards_tpu.models import heads as jheads
from deepards_tpu.models import resnet1d as jresnet
from deepards_tpu.train import steps as jsteps
from deepards_tpu_torch.cli.serve import InferenceEngine
from deepards_tpu_torch.models import heads, resnet1d
from deepards_tpu_torch.models.layers import bn_row_mask
from deepards_tpu_torch.models.registry import get_base_network
from deepards_tpu_torch.train import checkpoint
from deepards_tpu_torch.train.steps import make_optimizer
from deepards_tpu_torch.transplant import load_sgd_momentum, transplant

# parallel test workers share the cores: one torch thread each
torch.set_num_threads(1)

TOL = dict(atol=1e-4, rtol=1e-4)
B, S, L = 2, 3, 224
PLANES = 8


RESNETS = [
    ("resnet18", "max", False),
    ("resnet18", "avg", True),
    ("resnet34", "max", True),
    ("resnet50", "avg", False),
    ("resnet50", "max", True),
]


@pytest.mark.parametrize("name,pool,double", RESNETS)
def test_resnet_features_match_flax(name, pool, double):
    kw = dict(initial_planes=PLANES, first_pool_type=pool,
              double_conv_first=double)
    jmodel = getattr(jresnet, name)(**kw)
    x = windows(0, (B * S, 1, L))
    params = random_params(jmodel, 1, jnp.asarray(x))
    want = jit_apply(jmodel)(params, jnp.asarray(x), None)
    model = getattr(resnet1d, name)(**kw)
    model.load_state_dict(transplant(params))
    with torch.no_grad():
        got = model(torch.from_numpy(x), True).numpy()
    assert got.shape == (B * S, model.n_out_filters) == np.shape(want)
    np.testing.assert_allclose(got, np.asarray(want), **TOL)


def test_resnet_forward_no_pool_matches_flax():
    jmodel = jresnet.resnet18(initial_planes=PLANES)
    x = windows(2, (B * S, 1, L))
    params = random_params(jmodel, 3, jnp.asarray(x))
    want = jit_apply(jmodel, method=jresnet.ResNet1D.forward_no_pool)(
        params, jnp.asarray(x), None)
    model = resnet1d.resnet18(initial_planes=PLANES)
    model.load_state_dict(transplant(params))
    with torch.no_grad():
        got = model.forward_no_pool(torch.from_numpy(x), True).numpy()
    # port (N, C, L') vs JAX (N, L', C); L' = 7
    np.testing.assert_allclose(got, np.transpose(np.asarray(want), (0, 2, 1)),
                               **TOL)


@pytest.fixture(scope="module")
def cnn_resnet():
    """(flax cnn_linear over resnet18, its numpy-drawn params)."""
    jmodel = jheads.CNNLinearNetwork(
        breath_block=jresnet.resnet18(initial_planes=PLANES))
    x = jnp.zeros((B, S, 1, L), jnp.float32)
    return random_params(jmodel, 4, x, None, True)


def _port_cnn(params, bn_scope):
    model = heads.CNNLinearNetwork(resnet1d.resnet18(initial_planes=PLANES),
                                   S, bn_scope=bn_scope)
    model.load_state_dict(transplant(params))
    return model


@pytest.mark.parametrize("bn_scope", ["batch", "sequence"])
def test_cnn_linear_over_resnet18_matches_flax(cnn_resnet, bn_scope):
    """Logits of a padded batch (row mask over B*S rows) under either
    norm scope."""
    x = windows(5, (B + 1, S, 1, L))
    x[-1] = 0.0
    rows = np.repeat(np.float32([1, 1, 0]), S)
    jmodel = jheads.CNNLinearNetwork(
        breath_block=jresnet.resnet18(initial_planes=PLANES),
        bn_scope=bn_scope)
    want = np.asarray(jit_apply(jmodel, True)(cnn_resnet, jnp.asarray(x),
                                              jnp.asarray(rows), None))
    model = _port_cnn(cnn_resnet, bn_scope)
    with torch.no_grad(), bn_row_mask(torch.from_numpy(rows)):
        got = model(torch.from_numpy(x), True).numpy()
    assert got.shape == (B + 1, 2)
    np.testing.assert_allclose(got[:B], want[:B], **TOL)


@pytest.mark.parametrize("name,double", [("resnet18", True),
                                         ("resnet50", False)])
def test_resnet_transplant_round_trip(name, double):
    kw = dict(initial_planes=PLANES, double_conv_first=double)
    x = jnp.zeros((2, 1, L), jnp.float32)
    bare = random_params(getattr(jresnet, name)(**kw), 6, x)
    state = assert_round_trip(bare, getattr(resnet1d, name)(**kw))
    # creation order: the stem's second conv is the 7-wide one, a
    # block's downsample is its last conv
    stem = (PLANES, 1, 3) if double else (PLANES, 1, 7)
    assert tuple(state["convs.0.weight"].shape) == stem
    last = "convs.2.weight" if name == "resnet18" else "convs.3.weight"
    first_down = "blocks.2." if name == "resnet18" else "blocks.0."
    assert tuple(state[first_down + last].shape[2:]) == (1,)
    jnet = jheads.CNNLinearNetwork(breath_block=getattr(jresnet, name)(**kw))
    tree = random_params(jnet, 7, jnp.zeros((2, S, 1, L)), None, True)
    net = heads.CNNLinearNetwork(getattr(resnet1d, name)(**kw), S)
    assert "head.weight" in assert_round_trip(tree, net)


def test_registry_builds_resnets_from_conf():
    conf = {"base_network": "resnet50", "initial_planes": 4,
            "resnet_first_pool_type": "avg", "resnet_double_conv": True}
    model = get_base_network(conf, in_channels=2)
    assert model.first_pool_type == "avg" and len(model.convs) == 2
    assert model.convs[0].in_channels == 2
    assert model.n_out_filters == 4 * 8 * 4
    default = get_base_network({"base_network": "resnet18"})
    assert default.n_out_filters == 512 and len(default.convs) == 1
    assert default.convs[0].weight.shape == (64, 1, 7)
    a, b = (get_base_network(conf).reset_parameters(
        torch.Generator().manual_seed(1)) for _ in range(2))
    for (k, v), w in zip(a.state_dict().items(), b.state_dict().values()):
        assert torch.equal(v, w), k
    conv = a.blocks[0].convs[1].weight  # (4, 4, 3): std sqrt(2 / (3 * 4))
    assert 0.2 < float(conv.detach().std()) < 0.6
    assert torch.equal(a.norms[0].weight, torch.ones(4))
    with pytest.raises(ValueError, match="first_pool_type"):
        resnet1d.resnet18(first_pool_type="median")


def test_sgd_momentum_loads_for_resnet(cnn_resnet):
    """The momentum of config 2's optax chain, after two updates from
    numpy gradients, lands in a torch SGD over cnn_linear/resnet18."""
    tx = jsteps.make_optimizer("sgd", learning_rate=0.001,
                               weight_decay=0.0001, clip_grad=True,
                               clip_val=0.01)
    params = jax.tree_util.tree_map(jnp.asarray, cnn_resnet)
    opt_state = tx.init(params)
    rng = np.random.default_rng(8)
    update = jax.jit(tx.update)
    for _ in range(2):
        grads = jax.tree_util.tree_map(
            lambda p: jnp.asarray(rng.normal(size=p.shape) * 0.02,
                                  jnp.float32), params)
        updates, opt_state = update(grads, opt_state, params)
        params = jax.jit(optax.apply_updates)(params, updates)
    model = _port_cnn(cnn_resnet, "batch")
    optimizer = make_optimizer(model.parameters(), "sgd")
    load_sgd_momentum(optimizer.optimizer, model, opt_state)
    trace = transplant(opt_state[-1][0].trace)
    for name, p in model.named_parameters():
        assert torch.equal(optimizer.optimizer.state[p]["momentum_buffer"],
                           trace[name]), name


def test_jax_npz_checkpoint_serves_resnet(tmp_path):
    """An .npz of the JAX package's flat cnn_linear/resnet18 params (full
    width, which the server builds) restores and serves: the served
    probabilities are the flax forward's under per-sequence statistics
    (ResNet has no dropout)."""
    jmodel = jheads.CNNLinearNetwork(breath_block=jresnet.resnet18(),
                                     bn_scope="sequence")
    params = random_params(jmodel, 10, jnp.zeros((B, S, 1, L)), None, True)
    path = str(tmp_path / "jax_resnet.npz")
    np.savez(path, **traverse_util.flatten_dict(params, sep="/"))
    engine = InferenceEngine(path, base_network="resnet18", n_sub_batches=S,
                             batch_size=4, device="cpu")
    x = windows(9, (B + 1, S, 1, L))
    got = engine.predict(x)
    padded = np.concatenate([x, np.zeros((1, S, 1, L), np.float32)])
    want = jax.nn.softmax(jit_apply(jmodel, True)(
        params, jnp.asarray(padded), None, None))
    assert checkpoint.restore(path)["params"].keys() == set(
        engine.model.state_dict())
    np.testing.assert_allclose(got, np.asarray(want)[:B + 1], atol=1e-5,
                               rtol=0)


def test_config2_train_steps_match_jax():
    """Config 2's optimizer (clamp 0.01, decay, Nesterov SGD) over
    cnn_linear/resnet18: three steps as in the JAX package."""
    assert_three_train_steps_match_jax("config2")
