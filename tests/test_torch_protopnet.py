"""ProtoPNet-1D (benchmark config 5) on the CPU against the JAX package.

Numpy-drawn flax params carried over with ``transplant``, float32,
dropout off:

- the receptive-field arithmetic equals the JAX package's;
- ``PPNet`` logits and minimum distances within 1e-5 at prototype kernels
  K = 1 and K = 3 and with ``average_linear``;
- ``ppnet_loss`` within 1e-6 with and without row weights and the L1 term;
- the push: the same winners (window, position, distance) and prototype
  vectors as the JAX ``push_prototypes`` on the same params and windows,
  with a padded final batch;
- one step of each stage against a JAX oracle built here from ``PPNet``,
  ``ppnet_loss`` and the reference's staging (``optax.multi_transform``
  with ``set_to_zero`` outside the stage): the stage's params within 1e-5,
  every other param bit-equal to its init;
- the JAX trainer's own staging (``optax.masked``) moves the params
  outside a stage by their gradient, pinned.
"""
import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from flax import traverse_util
from test_torch_configs_2_3_4 import jit_apply, random_params, windows

import deepards_tpu.train.protopnet_trainer as jtrainer
from deepards_tpu.config import Configuration as JaxConfiguration
from deepards_tpu.data.dataset import ARDSRawDataset as JaxDataset
from deepards_tpu.data.pipeline import BatchPipeline as JaxPipeline
from deepards_tpu.data.windowing import WindowCache as JaxCache
from deepards_tpu.models import densenet1d as jdensenet
from deepards_tpu.models import protopnet1d as jprotopnet
from deepards_tpu.models.layers import bn_row_mask as jax_bn_row_mask
from deepards_tpu_torch.config.config import Configuration
from deepards_tpu_torch.data.dataset import ARDSRawDataset
from deepards_tpu_torch.data.pipeline import transform_batch
from deepards_tpu_torch.data.windowing import WindowCache
from deepards_tpu_torch.models import densenet1d, protopnet1d
from deepards_tpu_torch.models.registry import (
    get_base_network,
    get_network_spec,
)
from deepards_tpu_torch.train.protopnet_trainer import (
    STAGES,
    ProtoPNetTrainer,
    make_ppnet_steps,
    ppnet_loss,
    stage_groups,
)
from deepards_tpu_torch.train.steps import TrainState, make_optimizer
from deepards_tpu_torch.transplant import transplant

# parallel test workers share the cores: one torch thread each
torch.set_num_threads(1)

L = 224
S, B = 3, 4
PROTOS, CHANNELS = 4, 16  # 2 prototypes a class of 16 channels
MU, STD = 3.0, 20.0


def _t(x):
    return torch.from_numpy(np.asarray(x))


def _models(k=1, average_linear=False, s=S):
    """The flax PPNet over densenet18 (dropout off) and the port's."""
    jmodel = jprotopnet.PPNet(
        breath_block=jdensenet.densenet18(drop_rate=0.0), sub_batch_size=s,
        num_prototypes=PROTOS, proto_channels=CHANNELS, proto_kernel=k,
        average_linear=average_linear)
    model = protopnet1d.PPNet(
        densenet1d.densenet18(drop_rate=0.0), sub_batch_size=s,
        num_prototypes=PROTOS, proto_channels=CHANNELS, proto_kernel=k,
        average_linear=average_linear)
    return jmodel, model


def _params(jmodel, x, seed=1):
    """Numpy-drawn params; prototypes uniform in [0, 1), as PPNet's init
    draws them, so that the distances are those of training."""
    params = random_params(jmodel, seed, jnp.asarray(x), None, True)
    params["prototype_vectors"] = np.random.default_rng(seed).uniform(
        size=params["prototype_vectors"].shape).astype(np.float32)
    return params


@pytest.mark.parametrize("k", [1, 3])
def test_rf_info_matches_jax(k):
    jmodel, model = _models(k)
    want = jmodel.proto_layer_rf_info()
    assert model.proto_layer_rf_info() == want
    assert model.breath_block.conv_info() == jdensenet.densenet18().conv_info()
    for pos in (0, 3, 6):
        assert protopnet1d.compute_rf_boundaries(pos, want) == \
            jprotopnet.compute_rf_boundaries(pos, want)


@pytest.mark.parametrize("k,average_linear", [(1, False), (3, False),
                                              (1, True)])
def test_ppnet_matches_flax(k, average_linear):
    x = windows(0, (B, S, 1, L))
    jmodel, model = _models(k, average_linear)
    params = _params(jmodel, x)
    want_logits, want_d = jit_apply(jmodel, True)(params, jnp.asarray(x),
                                                  None, None)
    model.load_state_dict(transplant(params))
    with torch.no_grad():
        logits, min_d = model(_t(x), True)
    assert min_d.shape == (B, S * PROTOS)
    np.testing.assert_allclose(logits.numpy(), np.asarray(want_logits),
                               atol=1e-5, rtol=0)
    np.testing.assert_allclose(min_d.numpy(), np.asarray(want_d), atol=1e-5,
                               rtol=0)


def test_last_layer_init_is_the_class_identity():
    """The port's init: class identity tiled S times, +1 own class and
    incorrect_strength otherwise, as the flax init draws it."""
    x = windows(0, (1, S, 1, L))
    jmodel, model = _models()
    variables = jax.jit(lambda x: jmodel.init(
        {"params": jax.random.PRNGKey(0), "dropout": jax.random.PRNGKey(1)},
        x, None, True))(jnp.asarray(x))
    model.reset_parameters(torch.Generator().manual_seed(0))
    want = np.asarray(variables["params"]["last_layer"]["kernel"]).T
    np.testing.assert_array_equal(model.last_layer.weight.detach().numpy(),
                                  want)
    protos = model.prototype_vectors.detach()
    assert protos.shape == (PROTOS, CHANNELS, 1)
    assert float(protos.min()) >= 0 and float(protos.max()) < 1


@pytest.mark.parametrize("weighted,use_l1", [(False, False), (True, False),
                                             (True, True)])
def test_ppnet_loss_matches_jax(weighted, use_l1):
    rng = np.random.default_rng(3)
    logits = rng.normal(size=(B, 2)).astype(np.float32) * 3
    target = np.eye(2, dtype=np.float32)[rng.integers(0, 2, B)]
    min_d = rng.uniform(0, CHANNELS, size=(B, S * PROTOS)).astype(np.float32)
    ident = np.tile(protopnet1d.prototype_class_identity(PROTOS, 2), (S, 1))
    kernel = rng.normal(size=(S * PROTOS, 2)).astype(np.float32)
    weights = np.float32([1, 1, 0, 1]) if weighted else None
    want, want_aux = jtrainer.ppnet_loss(
        jnp.asarray(logits), jnp.asarray(target), jnp.asarray(min_d), ident,
        CHANNELS, 0.8, 0.2, use_l1, jnp.asarray(kernel),
        None if weights is None else jnp.asarray(weights))
    got, aux = ppnet_loss(
        _t(logits), _t(target), _t(min_d), _t(ident), CHANNELS, 0.8, 0.2,
        use_l1, _t(kernel), None if weights is None else _t(weights))
    for a, b in zip((got,) + aux, (want,) + tuple(want_aux)):
        np.testing.assert_allclose(float(a), float(b), atol=1e-6, rtol=0)
    assert (float(aux[3]) > 0) == use_l1


def _caches(n=22, s=S, seed=5):
    """The same raw windows of 4 patients as a window cache of each
    package."""
    rng = np.random.default_rng(seed)
    data = (rng.normal(size=(n, s, 1, L)) * STD + MU).astype(np.float32)
    patient = np.arange(n) % 4
    fields = dict(data=data,
                  target=np.eye(2, dtype=np.float32)[patient % 2],
                  hours=np.zeros((n, s), np.float32),
                  patient_idx=patient.astype(np.int32),
                  patients=["1", "2", "3", "4"])
    return JaxCache(**fields), WindowCache(**fields)


def _cohort_file(tmp_path):
    path = tmp_path / "cohort.csv"
    path.write_text("Patient Unique Identifier,Pathophysiology\n"
                    "1,OTHER\n2,ARDS\n3,OTHER\n4,ARDS\n")
    return str(path)


def _conf(tmp_path, **over):
    base = dict(network="protopnet", base_network="densenet18",
                n_sub_batches=S, batch_size=8, n_prototypes=PROTOS // 2,
                compute_dtype="float32", results_dir=str(tmp_path / "res"),
                dataset_type="unpadded_centered_sequences")
    base.update(over)
    return base


def test_push_matches_jax(tmp_path):
    """22 windows in batches of 8 (the last of 6, padded): the same
    winners, distances within 1e-5 and prototype vectors within 1e-5."""
    jcache, cache = _caches()
    cohort = _cohort_file(tmp_path)
    jds = JaxDataset(str(tmp_path), 1, cohort, S,
                     "unpadded_centered_sequences", cache=jcache)
    ds = ARDSRawDataset(str(tmp_path), 1, cohort, S,
                        "unpadded_centered_sequences", cache=cache)
    x = windows(0, (2, S, 1, L))
    jmodel = jprotopnet.PPNet(
        breath_block=jdensenet.densenet18(), sub_batch_size=S,
        num_prototypes=PROTOS, proto_channels=CHANNELS)
    params = _params(jmodel, x, seed=7)
    holder = type("Holder", (), {})()
    state = type("State", (), {"params": params,
                               "replace": lambda self, params: params})()
    new_params = jtrainer.ProtoPNetTrainer.push_prototypes(
        holder, state, jmodel, jds, JaxPipeline(jds), 8)
    want_info = holder.last_push_info
    trainer = ProtoPNetTrainer(Configuration(overrides=_conf(tmp_path)),
                               device="cpu", verbose=False)
    trainer.push_infos = []
    model = protopnet1d.PPNet(densenet1d.densenet18(), sub_batch_size=S,
                              num_prototypes=PROTOS, proto_channels=CHANNELS)
    model.load_state_dict(transplant(params))
    info = trainer.push_prototypes(model, ds)
    assert [(i["window_index"], i["flat_pos"]) for i in info] == \
        [(i["window_index"], i["flat_pos"]) for i in want_info]
    assert {i["window_index"] for i in info} <= set(range(22))
    np.testing.assert_allclose([i["distance"] for i in info],
                               [i["distance"] for i in want_info],
                               atol=1e-5, rtol=0)
    np.testing.assert_allclose(
        model.prototype_vectors.detach().numpy(),
        np.asarray(new_params["prototype_vectors"]), atol=1e-5, rtol=0)
    # each prototype moved onto a window of its own class
    labels = cache.target.argmax(axis=1)
    owner = model.class_identity().argmax(axis=1)
    assert all(labels[i["window_index"]] == owner[j]
               for j, i in enumerate(info))


def _jax_stage_oracle(jmodel, params, stage, batch, mask, lr=1e-3,
                      wd=1e-4):
    """One step of ``stage`` under the reference's staging: the JAX
    model and loss, an optax SGD over the stage's group, zero updates
    elsewhere."""
    masks = jtrainer._param_stage_masks(params)[stage]
    labels = jax.tree_util.tree_map(lambda m: "on" if m else "off", masks)
    tx = optax.multi_transform(
        {"on": optax.chain(optax.add_decayed_weights(wd),
                           optax.sgd(lr, momentum=0.9, nesterov=True)),
         "off": optax.set_to_zero()}, labels)
    ident = jnp.asarray(jmodel.class_identity_windows())
    mu, std = jnp.float32(MU), jnp.float32(STD)
    rows = jnp.repeat(jnp.asarray(mask), S)

    def loss(p):
        with jax_bn_row_mask(rows):
            logits, min_d = jmodel.apply(
                {"params": p}, (jnp.asarray(batch[0]) - mu) / std, None,
                True)
        return jtrainer.ppnet_loss(logits, jnp.asarray(batch[1]), min_d,
                                   ident, jmodel.max_dist,
                                   weights=jnp.asarray(mask))[0]

    value, grads = jax.jit(jax.value_and_grad(loss))(params)
    updates, _ = tx.update(grads, tx.init(params), params)
    return float(value), optax.apply_updates(params, updates)


@pytest.mark.parametrize("stage", STAGES)
def test_stage_step_matches_jax_oracle(stage):
    rng = np.random.default_rng(9)
    data = (rng.normal(size=(B, S, 1, L)) * STD + MU).astype(np.float32)
    target = np.eye(2, dtype=np.float32)[[0, 1, 1, 0]]
    mask = np.float32([1, 1, 1, 0])
    jmodel, model = _models()
    params = _params(jmodel, data / STD, seed=11)
    want_loss, want = _jax_stage_oracle(jmodel, params, stage,
                                        (data, target), mask)
    init = transplant(params)
    model.load_state_dict(init)
    steps, _ = make_ppnet_steps(
        model, lambda d: transform_batch(d, _t(np.float32([MU])),
                                         _t(np.float32([STD]))),
        _t(model.class_identity_windows()), model.max_dist,
        dropout_active=False)
    state = TrainState(model, make_optimizer(stage_groups(model)[stage]),
                       torch.Generator())
    out = steps[stage](state, _t(data), _t(target), _t(mask))
    assert abs(float(out[0]) - want_loss) <= 1e-5
    want = transplant(jax.tree_util.tree_map(np.asarray, want))
    group = {id(p) for p in stage_groups(model)[stage]}
    moved = 0
    for name, p in model.named_parameters():
        if id(p) in group:
            np.testing.assert_allclose(p.detach().numpy(), want[name].numpy(),
                                       atol=1e-5, rtol=0, err_msg=name)
            moved += not torch.equal(p.detach(), init[name])
        else:
            assert torch.equal(p.detach(), init[name]), name
            assert torch.equal(want[name], init[name]), name
    assert moved == len(group)


def test_jax_ppnet_stages_move_params_outside_the_stage():
    """The JAX trainer's ``_make_tx`` wraps each stage's optimizer in
    ``optax.masked``, which passes the raw gradient through as the update
    of every param outside the stage
    (``deepards_tpu/train/protopnet_trainer.py:163-167``): in the warm
    stage the backbone and the last layer move by +grad, at a step size
    of 1.  The reference's optimizers leave them alone; the port does
    too (``test_stage_step_matches_jax_oracle``)."""
    x = windows(0, (2, S, 1, L))
    jmodel, _ = _models()
    params = _params(jmodel, x)
    conf = JaxConfiguration(overrides=dict(learning_rate=1e-3,
                                           weight_decay=1e-4))
    holder = type("Holder", (), {"conf": conf})()
    txs = jtrainer.ProtoPNetTrainer._make_tx(holder, params)
    grads = jax.tree_util.tree_map(lambda p: jnp.full_like(p, 0.5), params)
    for stage, outside in (("warm", ("breath_block", "last_layer")),
                           ("last", ("breath_block", "add_on_layers",
                                     "prototype_vectors"))):
        tx = txs[stage]
        updates, _ = tx.update(grads, tx.init(params), params)
        moved = optax.apply_updates(params, updates)
        flat = traverse_util.flatten_dict(moved, sep="/")
        before = traverse_util.flatten_dict(params, sep="/")
        for key, value in flat.items():
            if key.split("/")[0] in outside:
                np.testing.assert_array_equal(
                    np.asarray(value), np.asarray(before[key]) + 0.5,
                    err_msg=key)


def test_bf16_distances_follow_the_jax_dtype_flow():
    """bfloat16 patches and prototypes: ``x**2`` and ``p**2`` summed in
    bfloat16, the cross term accumulated in float32, so the distances are
    float32 and within 1e-5 of the JAX package's; the cross term rounded
    to bfloat16 instead would miss them by far more."""
    rng = np.random.default_rng(4)
    feats = rng.uniform(0, 1, size=(6, 7, 32)).astype(np.float32)
    protos = rng.uniform(0, 1, size=(PROTOS, 32, 1)).astype(np.float32)
    jmodel = jprotopnet.PPNet(breath_block=jdensenet.densenet18(),
                              num_prototypes=PROTOS, proto_channels=32)
    want = jmodel.apply(
        {"params": {"prototype_vectors": jnp.asarray(protos, jnp.bfloat16)}},
        jnp.asarray(feats, jnp.bfloat16),
        method=lambda m, f: m.l2_distances(f))
    model = protopnet1d.PPNet(densenet1d.densenet18(), num_prototypes=PROTOS,
                              proto_channels=32).to(torch.bfloat16)
    with torch.no_grad():
        model.prototype_vectors.copy_(_t(protos))
        x = _t(feats).to(torch.bfloat16).transpose(1, 2)
        got = model.l2_distances(x)
        pv = model.prototype_vectors[:, :, 0]
        rounded = torch.relu(
            x.square().sum(1)[:, :, None] + pv.square().sum(1)
            - 2 * torch.matmul(x.transpose(1, 2), pv.t())).float()
    assert want.dtype == jnp.float32 and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5,
                               rtol=0)
    assert np.abs(rounded.numpy() - np.asarray(want)).max() > 1e-3


def test_registry_builds_config_5():
    """``protopnet`` builds config 5's PPNet from the configuration (10
    prototypes a class, the class-identity layer tiled S times) for the
    ProtoPNet trainer, evaluated with dropout off as that trainer does;
    ``protopnet_2d`` builds PPNet2D for the same trainer (one image's 20
    prototypes into the last layer)."""
    spec = get_network_spec("protopnet")
    conf = {"base_network": "densenet18", "n_prototypes": 10,
            "incorrect_strength": -0.5}
    model = spec.build(conf, get_base_network(conf), 20)
    assert (spec.trainer, spec.eval_dropout_off) == ("protopnet", True)
    assert model.prototype_shape == (20, 128, 1)
    assert tuple(model.last_layer.weight.shape) == (2, 400)
    spec_2d = get_network_spec("protopnet_2d")
    conf_2d = dict(conf, base_network="densenet18_2d")
    model_2d = spec_2d.build(conf_2d, get_base_network(conf_2d), 20)
    assert (spec_2d.trainer, spec_2d.two_dim) == ("protopnet", True)
    assert model_2d.prototype_shape == (20, 128)
    assert tuple(model_2d.last_layer.weight.shape) == (2, 20)
