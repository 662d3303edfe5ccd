"""Benchmark configs 2, 3 and 4 on the CPU against the JAX package.

- config 2 (``padded_breath_by_breath_resnet18.yml``): cnn_linear over
  resnet18, Nesterov SGD with the 0.01 clamp, (B, 2) targets;
- config 3 (``bm_pretraining_regression.yml``): cnn_regressor over
  densenet18, Adam, (B, 9) regression targets, the ``main`` holdout,
  S = 1;
- config 4 (``unpadded_centered_nb20_cnn_lstm.yml``): cnn_lstm over
  densenet18, per-breath logits (B, S, 2) against the target repeated over
  the S windows, eval with dropout off.

The heads of config 3 and the metadata-only network are held within
1e-5.  Three train steps of each config (float32, dropout off, numpy-drawn
params carried over with ``transplant``): losses within 1e-4, params
within 1e-5.  Whole runs of the trainers at lr 1e-4 (where a run is well
conditioned, ``test_torch_train_loop.py``), each fold of the port from
the params the JAX trainer initialised: configs 2 and 4 over 2 folds of
the shared synthetic cohort, per-step losses within 1e-4, votes, patient
rows and AUCs equal, the same predictions by hour; config 3 on its
holdout, ``test_mae``, ``test_mse`` and r2 within 1e-4.  Narrow where a
config allows it: resnet18 at ``initial_planes`` 8, S = 4.
"""
import math
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import traverse_util

import chip_smoke
import deepards_tpu.train.loop as jloop
import deepards_tpu_torch.train.loop as tloop
from deepards_tpu.config import Configuration as JaxConfiguration
from deepards_tpu.data import pipeline as jpipeline
from deepards_tpu.models import densenet1d as jdensenet
from deepards_tpu.models import heads as jheads
from deepards_tpu.models import recurrent as jrecurrent
from deepards_tpu.models import resnet1d as jresnet
from deepards_tpu.models.layers import bn_row_mask as jax_bn_row_mask
from deepards_tpu.train import losses as jlosses
from deepards_tpu.train import steps as jsteps
from deepards_tpu_torch.cli.train import build_parser
from deepards_tpu_torch.config.config import Configuration
from deepards_tpu_torch.data import pipeline
from deepards_tpu_torch.data.synthetic import generate_cohort
from deepards_tpu_torch.models import densenet1d, heads, recurrent, resnet1d
from deepards_tpu_torch.models.registry import (
    get_base_network,
    get_network_spec,
)
from deepards_tpu_torch.train import losses
from deepards_tpu_torch.train.steps import (
    TrainState,
    make_optimizer,
    make_train_step,
)
from deepards_tpu_torch.transplant import transplant

# parallel test workers share the cores: one torch thread each
torch.set_num_threads(1)

L = 224
PLANES = 8
MU, STD = np.float32([3.0]), np.float32([20.0])


def _t(x):
    return torch.from_numpy(np.asarray(x))


# -- helpers shared with test_torch_resnet.py and test_torch_recurrent.py --


def random_params(module, seed, *args):
    """A flax param tree of ``module``'s shapes drawn by numpy: kernels
    normal(0, 1/sqrt(fan_in)), norm scales 1 + N(0, 0.1^2), biases
    N(0, 0.1^2)."""
    # the args are closed over, so Python flags stay static in the trace
    shapes = jax.eval_shape(lambda key: module.init(key, *args),
                            jax.random.PRNGKey(0))
    rng = np.random.default_rng(seed)
    out = {}
    for path, leaf in traverse_util.flatten_dict(shapes["params"]).items():
        if path[-1] == "kernel":
            value = rng.normal(size=leaf.shape) / math.sqrt(
                np.prod(leaf.shape[:-1]))
        elif path[-1] == "scale":
            value = 1 + 0.1 * rng.normal(size=leaf.shape)
        else:
            value = 0.1 * rng.normal(size=leaf.shape)
        out[path] = value.astype(np.float32)
    return traverse_util.unflatten_dict(out)


def jit_apply(module, *tail, **kw):
    """``(params, x, rows[, metadata]) -> module.apply({"params": params},
    x[, metadata], *tail, **kw)`` under ``jax.jit``, with the row mask (or
    None) scoped inside the trace: one compile in place of an eager
    dispatch per op."""

    def apply(params, x, rows, *meta):
        with jax_bn_row_mask(rows):
            return module.apply({"params": params}, x, *meta, *tail, **kw)

    return jax.jit(apply)


def windows(seed, shape):
    return np.random.default_rng(seed).normal(size=shape).astype(np.float32)


def assert_round_trip(params, model):
    """Every flax leaf lands on one port tensor, which holds it (kernels
    transposed); the nested and the flat tree agree; the port's model
    loads the result strictly."""
    state = transplant(params)
    flat = traverse_util.flatten_dict(params, sep="/")
    from_flat = transplant(flat)
    assert from_flat.keys() == state.keys()
    assert all(torch.equal(from_flat[k], v) for k, v in state.items())
    assert len(state) == len(flat) and set(state) == set(model.state_dict())
    # the leaves are distinct draws: each comes back from exactly one
    # port tensor
    back = [t.numpy().transpose(tuple(range(t.ndim))[::-1])
            for t in state.values()]
    for key, value in flat.items():
        hits = [b for b in back
                if b.shape == value.shape and np.array_equal(b, value)]
        assert len(hits) == 1, key
    model.load_state_dict(state)
    return state


def test_cnn_regressor_matches_flax():
    x = windows(0, (4, 1, 1, L))
    jmodel = jheads.CNNRegressor(
        breath_block=jresnet.resnet18(initial_planes=PLANES), n_outputs=9)
    params = random_params(jmodel, 1, jnp.asarray(x), None, True)
    want = jit_apply(jmodel, True)(params, jnp.asarray(x), None, None)
    model = heads.CNNRegressor(resnet1d.resnet18(initial_planes=PLANES), 1)
    model.load_state_dict(transplant(params))
    with torch.no_grad():
        got = model(_t(x), True).numpy()
    assert got.shape == (4, 9)
    np.testing.assert_allclose(got, np.asarray(want), atol=1e-5, rtol=0)


def test_metadata_only_matches_flax():
    meta = windows(2, (4, 5, 9))
    jmodel = jheads.MetadataOnlyNetwork()
    params = random_params(jmodel, 3, None, jnp.asarray(meta), True)
    want = jmodel.apply({"params": params}, None, jnp.asarray(meta), True)
    model = heads.MetadataOnlyNetwork()
    model.load_state_dict(transplant(params))
    with torch.no_grad():
        got = model(None, True, None, _t(meta)).numpy()
    np.testing.assert_allclose(got, np.asarray(want), atol=1e-5, rtol=0)
    with pytest.raises(ValueError, match="metadata"):
        model(torch.zeros(4, 5, 1, L), True)


# name -> (flax model, port model, S, B, optimizer, target_mode)
def _config2():
    return (jheads.CNNLinearNetwork(
        breath_block=jresnet.resnet18(initial_planes=PLANES)),
        heads.CNNLinearNetwork(resnet1d.resnet18(initial_planes=PLANES), 4),
        4, 4, "sgd", "per_sample")


def _config3():
    return (jheads.CNNRegressor(breath_block=jdensenet.densenet18()),
            heads.CNNRegressor(densenet1d.densenet18(), 1),
            1, 8, "adam", "regression")


def _config4():
    return (jrecurrent.CNNLSTMNetwork(breath_block=jdensenet.densenet18(),
                                      lstm_hidden_units=16),
            recurrent.CNNLSTMNetwork(densenet1d.densenet18(), 16),
            4, 4, "sgd", "per_breath")


CONFIGS = {"config2": _config2, "config3": _config3, "config4": _config4}
OPTIONS = {"sgd": dict(learning_rate=0.001, weight_decay=0.0001,
                       clip_grad=True, clip_val=0.01),
           "adam": dict(learning_rate=0.001)}


def _batches(s, b, target_mode, seed=4, channels=1):
    """Three raw batches; the last row of each is a pad row (mask 0)."""
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(3):
        data = (rng.normal(size=(b, s, channels, L)) * 20 + 3).astype(
            np.float32)
        if target_mode == "regression":
            target = (rng.normal(size=(b, 9)) * 2 + 1).astype(np.float32)
        else:
            target = np.eye(2, dtype=np.float32)[rng.integers(0, 2, b)]
        mask = np.ones(b, np.float32)
        mask[-1] = 0.0
        out.append((data, target, mask))
    return out


def assert_three_train_steps_match_jax(name):
    """Three steps of config ``name`` from the same params in both
    packages: losses within 1e-4, every param within 1e-5 after each."""
    assert_train_steps_match_jax(*CONFIGS[name]())


def assert_train_steps_match_jax(jmodel, model, s, b, optimizer,
                                 target_mode, steps=3, loss_atol=1e-4,
                                 channels=1):
    """``steps`` train steps of ``jmodel`` and its port ``model`` over (b,
    s, channels, L) batches from the same params: losses within
    ``loss_atol``, every param within 1e-5 after each."""
    loss_name = ("mse" if target_mode in ("regression", "autoencoder")
                 else "bce_with_logits")
    opts = OPTIONS[optimizer]
    tx = jsteps.make_optimizer(optimizer, **opts)
    params = random_params(jmodel, 5, jnp.zeros((b, s, channels, L)), None,
                           True)
    jstate = jsteps.TrainState(params=params, opt_state=tx.init(params),
                               rng=jax.random.PRNGKey(0),
                               step=jnp.zeros((), jnp.int32))
    mu, std = jnp.asarray(MU), jnp.asarray(STD)
    jtrain, _, _, _ = jsteps.make_train_step(
        jmodel, tx, getattr(jlosses, loss_name), target_mode=target_mode,
        transform=lambda d: jpipeline.transform_batch(
            d, mu, std, jnp.zeros((1, 6), jnp.float32)),
        dropout_active=False)
    model.load_state_dict(transplant(params))
    state = TrainState(model, make_optimizer(model.parameters(), optimizer,
                                             **opts), torch.Generator())
    ttrain, _ = make_train_step(
        getattr(losses, loss_name),
        transform=lambda d: pipeline.transform_batch(d, _t(MU), _t(STD)),
        dropout_active=False, target_mode=target_mode)
    batches = _batches(s, b, target_mode, channels=channels)[:steps]
    for step, (data, target, mask) in enumerate(batches):
        jstate, jloss = jtrain(jstate, {"data": jnp.asarray(data),
                                        "target": jnp.asarray(target)},
                               jnp.asarray(mask))
        tloss = ttrain(state, _t(data), _t(target), _t(mask))
        assert abs(float(tloss) - float(jloss)) <= loss_atol, (
            step, tloss, jloss)
        want = transplant(jax.tree_util.tree_map(np.asarray, jstate.params))
        for k, v in model.state_dict().items():
            np.testing.assert_allclose(v.numpy(), want[k].numpy(), atol=1e-5,
                                       rtol=0, err_msg="{} {}".format(step, k))


def test_config3_train_steps_match_jax():
    """Adam against optax.adam and the (B, 9) regression target."""
    assert_three_train_steps_match_jax("config3")


def test_chip_smoke_adam_reference_matches_optax():
    """chip_smoke.py's ``Float32CountAdam`` (the card's capturable Adam
    written out, the CPU side of config 3's card-vs-CPU check) is
    ``optax.adam``: bias corrections in float32 from the step count.
    Three steps of gradients from 1e-9 to 1 (eps's regime included),
    params within 1e-6."""
    import optax

    rng = np.random.default_rng(6)
    shapes = [(64,), (8, 16)]
    init = [rng.normal(size=s).astype(np.float32) for s in shapes]
    grads = [[(rng.normal(size=s) * 10.0 ** rng.uniform(-9, 0, size=s))
              .astype(np.float32) for s in shapes] for _ in range(3)]
    tx = optax.adam(1e-3)
    jparams = [jnp.asarray(p) for p in init]
    jstate = tx.init(jparams)
    params = [torch.nn.Parameter(_t(p.copy())) for p in init]
    adam = chip_smoke.Float32CountAdam(params, 1e-3)
    for g in grads:
        updates, jstate = tx.update([jnp.asarray(x) for x in g], jstate)
        jparams = optax.apply_updates(jparams, updates)
        for p, x in zip(params, g):
            p.grad = _t(x)
        adam.step()
        for p, want in zip(params, jparams):
            np.testing.assert_allclose(p.detach().numpy(), np.asarray(want),
                                       atol=1e-6, rtol=0)


def test_unknown_target_mode_raises():
    with pytest.raises(ValueError, match="target_mode"):
        make_train_step(losses.mse, target_mode="reconstruction")


# -- whole runs --------------------------------------------------------------


def _overrides(cohort, tmp_path, **over):
    base = dict(
        data_path=cohort["data_path"], cohort_file=cohort["cohort_file"],
        experiment_num=1, kfolds=2, epochs=1, batch_size=8,
        learning_rate=0.0001, weight_decay=0.0001, clip_grad=True,
        clip_val=0.01, oversample_minority=True, compute_dtype="float32",
        dp_devices=1, results_dir=str(tmp_path / "results"), seed=7,
        n_sub_batches=4,
    )
    base.update(over)
    return base


# the configs' networks and data narrowed for whole runs: resnet18 at 8
# initial planes under all three (densenet18 is held in the step tests)
RUNS = {
    "config2": dict(network="cnn_linear", base_network="resnet18",
                    initial_planes=PLANES,
                    dataset_type="padded_breath_by_breath"),
    "config3": dict(network="cnn_regressor", base_network="resnet18",
                    initial_planes=PLANES,
                    dataset_type="padded_breath_by_breath_with_full_bm_target",
                    holdout_set_type="main", kfolds=None, n_sub_batches=1,
                    oversample_minority=False, clip_grad=False,
                    optimizer="adam", batch_size=64, epochs=2),
    "config4": dict(network="cnn_lstm", base_network="resnet18",
                    initial_planes=PLANES, time_series_hidden_units=16,
                    dataset_type="unpadded_centered_sequences"),
}


def _no_dropout(make_step):
    def wrapped(*args, **kw):
        kw["dropout_active"] = False
        kw["eval_dropout_active"] = False
        return make_step(*args, **kw)
    return wrapped


def _runs(cohort, tmp_path, name, over=None):
    """The JAX trainer's results and the port's, each fold of both from
    the same params: numpy draws in the shapes of the JAX trainer's model
    (its eager ``model.init`` would take half the run).  ``over``: the
    run's options, RUNS[name] by default."""
    inits = []

    def numpy_init(model, tx, sample, rng, has_metadata=False,
                   rng_impl=None):
        meta = sample.get("metadata") if has_metadata else None
        params = random_params(model, len(inits), jnp.asarray(
            sample["data"]), None if meta is None else jnp.asarray(meta),
            True)
        inits.append(transplant(params))
        return jsteps.TrainState(
            params=params, opt_state=tx.init(params),
            rng=jsteps.make_state_rng(rng, rng_impl),
            step=jnp.zeros((), jnp.int32))

    over = RUNS[name] if over is None else over
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jloop, "create_train_state", numpy_init)
        mp.setattr(jloop, "make_train_step",
                   _no_dropout(jloop.make_train_step))
        mp.setattr(tloop, "make_train_step",
                   _no_dropout(tloop.make_train_step))
        jres = jloop.Trainer(JaxConfiguration(overrides=_overrides(
            cohort, tmp_path / "jax", **over)), verbose=False
        ).train_and_test()
        trainer = tloop.Trainer(Configuration(overrides=_overrides(
            cohort, tmp_path / "port", **over)), device="cpu", verbose=False)
        runs = iter(inits)
        trainer.init_model = lambda model, fold: model.load_state_dict(
            next(runs))
        trainer.train_and_test()
    return jres, trainer


def _meters(results, prefix):
    return {k: v.values for k, v in results.reporting.meters.items()
            if k.startswith(prefix)}


def _assert_losses_close(port, jres, atol=0, rtol=0):
    for prefix in ("loss_epoch_", "test_loss_fold_"):
        got, want = _meters(port, prefix), _meters(jres, prefix)
        assert got.keys() == want.keys() and got
        for key in want:
            np.testing.assert_allclose(got[key], want[key], atol=atol,
                                       rtol=rtol, err_msg=key)


def _hour_rows(rows):
    return sorted((r["patient"], r["y"], round(float(r["hour"]), 4),
                   r["pred"], r["epoch"], r["fold"]) for r in rows)


def assert_classifier_run_matches_jax(cohort, tmp_path, name, over=None):
    """Config ``name``'s 2-fold run: per-step losses within 1e-4; votes,
    patient rows and AUCs equal; the predictions by hour equal as sets of
    rows (a per-breath head gives each window S predictions, which the
    JAX package orders by an unstable sort of the window index and the
    port by a stable one).  Returns the port's trainer."""
    jres, trainer = _runs(cohort, tmp_path, name, over)
    port = trainer.results
    _assert_losses_close(port, jres, atol=1e-4)
    want = jres.results.to_dict(orient="records")
    assert port.results == want and len(want) == 2 * 4
    for fold in (0, 1):
        assert port.get_meter("test_auc", fold).values == \
            jres.get_meter("test_auc", fold).values
    hours = jres.all_pred_to_hour.to_dict(orient="records")
    assert _hour_rows(port.all_pred_to_hour) == _hour_rows(hours)
    return trainer


@pytest.fixture(scope="module")
def holdout_cohort(tmp_path_factory):
    """A small cohort with the ``main`` holdout's two directories."""
    data_path = str(tmp_path_factory.mktemp("holdout"))
    cohort_file = generate_cohort(
        data_path, n_patients=4, n_breaths_per_patient=120, seed=5,
        subdirs=("aim1_70_30_training", "aim1_70_30_testing"))
    return {"data_path": data_path, "cohort_file": cohort_file}


def test_regressor_run_matches_jax(holdout_cohort, tmp_path):
    """Config 3's two epochs on the holdout: per-step losses and the test
    MAE and MSE within 1e-4 relative (the targets are unscaled breath
    metadata, so the MSE is ~10^2 and float32 carries 1e-5 relative of
    it), r2 within 1e-4."""
    jres, trainer = _runs(holdout_cohort, tmp_path, "config3")
    port = trainer.results
    _assert_losses_close(port, jres, rtol=1e-4)
    for meter, tol in (("test_mae", dict(rtol=1e-4)),
                       ("test_mse", dict(rtol=1e-4)),
                       ("test_r2", dict(atol=1e-4))):
        got = port.get_meter(meter, 0).values
        assert len(got) == 2
        np.testing.assert_allclose(got, jres.get_meter(meter, 0).values,
                                   err_msg=meter, **tol)
    assert port.results == [] and trainer.last_eval["logits"].shape[1] == 9


# -- the port alone -----------------------------------------------------------


def _meta_only_trainer(cohort, tmp_path, **over):
    return tloop.Trainer(Configuration(overrides=_overrides(
        cohort, tmp_path, network="metadata_only",
        dataset_type="padded_breath_by_breath_with_flow_time_features",
        only_fold=0, **over)), device="cpu", verbose=False)


def test_network_without_backbone_trains(synthetic_cohort, tmp_path):
    """metadata_only has no breath_block: it initialises and trains, and
    asking to freeze or load its base network is refused by name."""
    trainer = _meta_only_trainer(synthetic_cohort, tmp_path)
    trainer.train_and_test()
    assert trainer.results.get_meter("loss", 0).values
    assert not hasattr(trainer.final_state.model, "breath_block")
    frozen = _meta_only_trainer(synthetic_cohort, tmp_path,
                                freeze_base_network=True)
    frozen.n_sub_batches = 4
    with pytest.raises(ValueError, match="freeze-base-network"):
        frozen.new_state(0)
    with pytest.raises(ValueError, match="load-base-network"):
        trainer.load_base_network(trainer.final_state, "unused.pt")


@pytest.mark.parametrize("over,match", [
    (dict(network="siamese_cnn_linear"), "kfolds"),
    (dict(network="siamese_cnn_lstm", parallel_folds=True), "kfolds"),
    (dict(network="siamese_cnn_transformer", kfolds=None, bootstrap=True),
     "bootstrap"),
    (dict(network="autoencoder", base_network="densenet18"), "basic_cnn_ae"),
    (dict(network="siamese_pretrained", siamese_time_layer="gru"),
     "siamese_time_layer"),
])
def test_unported_paths_raise(synthetic_cohort, tmp_path, over, match):
    """What the port refuses by name: folds for the siamese trainer's
    networks, the autoencoder over another backbone than basic_cnn_ae, an
    unknown time layer; and an unknown base network."""
    with pytest.raises(ValueError, match=match):
        trainer = tloop.make_trainer(Configuration(overrides=_overrides(
            synthetic_cohort, tmp_path, **over)), device="cpu")
        trainer.n_sub_batches = 4
        trainer.build_model()
    with pytest.raises(ValueError, match="unknown base network"):
        get_base_network({"base_network": "vgg19"})


def test_registry_specs_of_the_new_networks():
    assert get_network_spec("cnn_regressor").kind == "regressor"
    lstm = get_network_spec("cnn_lstm")
    assert (lstm.target_mode, lstm.expand_obs_idx, lstm.eval_dropout_off,
            lstm.stateful_lstm) == ("per_breath", True, True, True)
    conf = {"base_network": "densenet18", "time_series_hidden_units": 8,
            "bm_to_linear": True,
            "dataset_type": "padded_breath_by_breath_with_limited_bm_target"}
    model = lstm.build(conf, get_base_network(conf), 20, 9)
    assert model.lstm.hidden_size == 8 and model.head.in_features == 8 + 9
    regressor = get_network_spec("cnn_regressor").build(
        conf, get_base_network(conf), 1)
    assert regressor.head.out_features == 3
    with pytest.raises(ValueError, match="unknown network"):
        get_network_spec("no_such_network")


EXPERIMENTS = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "deepards_tpu", "config", "experiment_files")


@pytest.mark.parametrize("name,yml", [
    ("config2", "padded_breath_by_breath_resnet18.yml"),
    ("config3", "bm_pretraining_regression.yml"),
    ("config4", "unpadded_centered_nb20_cnn_lstm.yml"),
    ("config5", "unpadded_centered_nb20_protopnet.yml"),
])
def test_chip_smoke_flags_give_the_config(name, yml):
    """chip_smoke.py's flags give the yml's configuration (the card's
    machine has no PyYAML); a bool flag left unset (None) reads as the
    yml's false."""
    def conf(argv):
        out = Configuration(build_parser().parse_args(argv)).conf
        out.pop("config_override")
        return out

    got = conf(chip_smoke.CONFIG_FLAGS[name])
    want = conf(["-co", os.path.join(EXPERIMENTS, yml)])
    for key in set(got) | set(want):
        a, b = got.get(key), want.get(key)
        if isinstance(a, bool) or isinstance(b, bool):
            assert bool(a) == bool(b), key
        else:
            assert a == b, key
