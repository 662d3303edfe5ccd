"""Parallel folds (``parallel_folds``, the JAX benchmark's config 7) on the
CPU against the JAX package: cnn_linear over densenet18, S = 4, float32,
dropout off (densenet18 built with drop rate 0 in both packages).

- a stacked step of 2 folds (each its own params, scaling and batch, pad
  rows) against a JAX oracle of the package's vmapped fold step: losses
  and params within 1e-5;
- each fold's slice of a stacked step against the port's own sequential
  step of that fold, in float64, within 1e-10;
- a whole 2-fold run (one epoch, at lr 1e-4) against the JAX
  ``ParallelFoldTrainer``, each fold of the port from the params the JAX
  trainer initialised for it: per-step losses within 1e-4, votes,
  patient rows and AUCs equal;
- the per-fold checkpoints are read by ``cli.predict``, whose
  probabilities are the trainer's eval of the fold within 1e-5.
"""
import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from test_torch_configs_2_3_4 import random_params, windows

import deepards_tpu.models.registry as jregistry
import deepards_tpu.train.loop as jloop
import deepards_tpu.train.parallel_folds as jpf
import deepards_tpu_torch.models.registry as tregistry
import deepards_tpu_torch.train.loop as tloop
from deepards_tpu.config import Configuration as JaxConfiguration
from deepards_tpu.models import densenet1d as jdensenet
from deepards_tpu.models import heads as jheads
from deepards_tpu.models.layers import bn_row_mask as jax_bn_row_mask
from deepards_tpu.train import losses as jlosses
from deepards_tpu.train import steps as jsteps
from deepards_tpu_torch.cli.predict import main as predict_main
from deepards_tpu_torch.config.config import Configuration
from deepards_tpu_torch.data.pipeline import transform_batch
from deepards_tpu_torch.models import densenet1d, heads
from deepards_tpu_torch.train import losses
from deepards_tpu_torch.train.parallel_folds import (
    ParallelFoldTrainer,
    StackedParams,
    make_fold_steps,
)
from deepards_tpu_torch.train.steps import (
    TrainState,
    make_optimizer,
    make_train_step,
)
from deepards_tpu_torch.transplant import transplant

# parallel test workers share the cores: one torch thread each
torch.set_num_threads(1)

F, B, S, L = 2, 4, 4, 224
OPT = dict(learning_rate=0.001, weight_decay=0.0001, clip_grad=True,
           clip_val=0.01)


def _t(x):
    return torch.from_numpy(np.ascontiguousarray(x))


def _batch(seed=3):
    """Each fold's raw batch, targets, row mask (a pad row in fold 1) and
    (mu, std)."""
    rng = np.random.default_rng(seed)
    data = (rng.normal(size=(F, B, S, 1, L)) * 20 + 3).astype(np.float32)
    target = np.eye(2, dtype=np.float32)[rng.integers(0, 2, (F, B))]
    mask = np.ones((F, B), np.float32)
    mask[1, -1] = 0.0
    mus = np.float32([[2.0], [4.0]])
    stds = np.float32([[18.0], [22.0]])
    return data, target, mask, mus, stds


def _fold_params():
    jmodel = jheads.CNNLinearNetwork(breath_block=jdensenet.densenet18())
    x = jnp.asarray(windows(0, (2, S, 1, L)))
    return jmodel, [random_params(jmodel, 10 + f, x, None, True)
                    for f in range(F)]


def _stacked(states, names):
    return StackedParams(names, [torch.stack([s[n] for s in states])
                                 for n in names])


def test_stacked_step_matches_jax_vmapped_step():
    """The JAX package's vmapped fold step (its ``fold_train_step``
    written out: per-fold scaling, the row mask for the norms and the
    loss, config 1's clipped Nesterov SGD) against the port's."""
    data, target, mask, mus, stds = _batch()
    jmodel, fold_params = _fold_params()
    tx = jsteps.make_optimizer("sgd", **OPT)

    def fold_loss(params, data, target, mask, mu, std):
        data = (data - mu.reshape(1, 1, -1, 1)) / std.reshape(1, 1, -1, 1)
        with jax_bn_row_mask(jnp.repeat(mask, data.shape[1])):
            out = jmodel.apply({"params": params}, data, None, True)
        return jlosses.bce_with_logits(out, target, mask)

    def fold_step(params, opt_state, data, target, mask, mu, std):
        loss, grads = jax.value_and_grad(fold_loss)(params, data, target,
                                                    mask, mu, std)
        updates, opt_state = tx.update(grads, opt_state, params)
        return optax.apply_updates(params, updates), opt_state, loss

    stacked = jax.tree_util.tree_map(lambda *x: jnp.stack(x), *fold_params)
    opt_state = jax.vmap(tx.init)(stacked)
    want_params, _, want_loss = jax.jit(jax.vmap(fold_step))(
        stacked, opt_state, *(jnp.asarray(a) for a in
                              (data, target, mask, mus, stds)))
    states = [transplant(p) for p in fold_params]
    template = heads.CNNLinearNetwork(densenet1d.densenet18(), S)
    names = [n for n, _ in template.named_parameters()]
    params = _stacked(states, names)
    state = TrainState(params, make_optimizer(params.parameters(), **OPT),
                       torch.Generator())
    step, _ = make_fold_steps(template, losses.bce_with_logits, _t(mus),
                              _t(stds), dropout_active=False)
    got_loss = step(state, _t(data), _t(target), _t(mask))
    np.testing.assert_allclose(got_loss.numpy(), np.asarray(want_loss),
                               atol=1e-5, rtol=0)
    want = [transplant(jax.tree_util.tree_map(lambda x: np.asarray(x[f]),
                                              want_params))
            for f in range(F)]
    for n, p in params.as_dict().items():
        for f in range(F):
            np.testing.assert_allclose(p[f].detach().numpy(),
                                       want[f][n].numpy(), atol=1e-5, rtol=0,
                                       err_msg="{} fold {}".format(n, f))


def test_fold_slices_match_sequential_steps_float64():
    """Two stacked steps against each fold's own sequential steps
    (``make_train_step`` with the fold's scaling), float64: losses and
    params within 1e-10; fold 0's slice is not fold 1's step."""
    data, target, mask, mus, stds = _batch()
    _, fold_params = _fold_params()
    states = [{k: v.double() for k, v in transplant(p).items()}
              for p in fold_params]
    template = heads.CNNLinearNetwork(densenet1d.densenet18(), S).double()
    names = [n for n, _ in template.named_parameters()]
    params = _stacked(states, names)
    state = TrainState(params, make_optimizer(params.parameters(), **OPT),
                       torch.Generator())
    step, _ = make_fold_steps(template, losses.bce_with_logits,
                              _t(mus).double(), _t(stds).double(),
                              dropout_active=False)
    stacked_losses = [step(state, *(_t(a).double() for a in
                                    (data, target, mask)))
                      for _ in range(2)]
    for f in range(F):
        model = heads.CNNLinearNetwork(densenet1d.densenet18(), S).double()
        model.load_state_dict(states[f])
        seq = TrainState(model, make_optimizer(model.parameters(), **OPT),
                         torch.Generator())
        mu, std = _t(mus[f]).double(), _t(stds[f]).double()
        train, _ = make_train_step(
            losses.bce_with_logits,
            transform=lambda d: transform_batch(d, mu, std),
            dropout_active=False)
        for k in range(2):
            loss = train(seq, *(_t(a[f]).double() for a in
                                (data, target, mask)))
            assert abs(float(loss) - float(stacked_losses[k][f])) <= 1e-10
        for n, p in model.named_parameters():
            np.testing.assert_allclose(
                params.as_dict()[n][f].detach().numpy(),
                p.detach().numpy(), atol=1e-10, rtol=0, err_msg=n)
            if f == 1 and n == "head.weight":
                assert np.abs(params.as_dict()[n][0].detach().numpy()
                              - p.detach().numpy()).max() > 1e-3


# -- whole runs ---------------------------------------------------------------


def _overrides(cohort, tmp_path, **over):
    base = dict(
        data_path=cohort["data_path"], cohort_file=cohort["cohort_file"],
        experiment_num=1, network="cnn_linear", base_network="densenet18",
        dataset_type="unpadded_centered_sequences", n_sub_batches=S,
        kfolds=2, epochs=1, batch_size=8, optimizer="sgd",
        learning_rate=0.0001, weight_decay=0.0001, clip_grad=True,
        clip_val=0.01, oversample_minority=True, compute_dtype="float32",
        dp_devices=1, results_dir=str(tmp_path / "results"), seed=7,
        parallel_folds=True,
    )
    base.update(over)
    return base


def _no_dropout(mp):
    mp.setitem(jregistry.BASE_NETWORKS, "densenet18",
               lambda conf: jdensenet.densenet18(drop_rate=0.0))
    mp.setitem(tregistry.BASE_NETWORKS, "densenet18",
               lambda conf, c: densenet1d.densenet18(in_channels=c,
                                                     drop_rate=0.0))


def _meters(results, prefix):
    return {k: v.values for k, v in results.reporting.meters.items()
            if k.startswith(prefix)}


@pytest.fixture(scope="module")
def runs(synthetic_cohort, tmp_path_factory):
    """The JAX ParallelFoldTrainer's results and the port's trainer, each
    fold of the port from the JAX trainer's init of that fold."""
    tmp = tmp_path_factory.mktemp("parallel")
    stacked = []
    real_state = jpf.TrainState

    def recording(**kw):
        stacked.append(jax.tree_util.tree_map(np.asarray, kw["params"]))
        return real_state(**kw)

    with pytest.MonkeyPatch.context() as mp:
        _no_dropout(mp)
        mp.setattr(jpf, "TrainState", recording)
        jres = jloop.make_trainer(JaxConfiguration(overrides=_overrides(
            synthetic_cohort, tmp / "jax")), verbose=False).train_and_test()
        trainer = tloop.make_trainer(Configuration(overrides=_overrides(
            synthetic_cohort, tmp / "port", save_model="pf.pt",
            saved_models_dir=str(tmp / "models"))), device="cpu",
            verbose=False)
        assert isinstance(trainer, ParallelFoldTrainer)
        trainer.init_model = lambda model, fold: model.load_state_dict(
            transplant(jax.tree_util.tree_map(lambda x: x[fold],
                                              stacked[0])))
        trainer.train_and_test()
    return jres, trainer, tmp


def test_run_matches_jax_parallel_fold_trainer(runs):
    jres, trainer, _ = runs
    port = trainer.results
    for prefix in ("loss_epoch_", "test_loss_fold_"):
        got, want = _meters(port, prefix), _meters(jres, prefix)
        assert got.keys() == want.keys() and got
        for name in want:
            np.testing.assert_allclose(got[name], want[name], atol=1e-4,
                                       rtol=0, err_msg=name)
    want = jres.results.to_dict(orient="records")
    assert port.results == want and len(want) == 2 * 4
    for fold in (0, 1):
        assert port.get_meter("test_auc", fold).values == \
            jres.get_meter("test_auc", fold).values


def test_fold_checkpoints_are_read_by_predict(runs, synthetic_cohort):
    """``cli.predict`` on each fold's checkpoint (the sequential layout,
    with its fold's scaling) gives the trainer's last eval of the fold."""
    _, trainer, tmp = runs
    conf = _overrides(synthetic_cohort, tmp / "predict")
    flags = ["--data-path", conf["data_path"], "--cohort-file",
             conf["cohort_file"], "--network", "cnn_linear", "-nb", str(S),
             "--kfolds", "2", "--batch-size", "8", "--compute-dtype",
             "float32", "--oversample-minority", "--seed", "7",
             "--device", "cpu", "--results-dir", str(tmp / "predict")]
    with pytest.MonkeyPatch.context() as mp:
        _no_dropout(mp)
        for fold in (0, 1):
            rows, votes = predict_main([
                "--checkpoint", str(tmp / "models" / "pf-fold{}".format(fold)),
                "-o", str(tmp / "p.csv"), "--votes-output",
                str(tmp / "v.json"), "--only-fold", str(fold)] + flags)
            want = trainer.last_eval[fold]
            assert [r["window_index"] for r in rows] == \
                want["index"].tolist()
            probs = torch.softmax(torch.from_numpy(want["logits"]), -1)
            got = np.array([[r["prob_other"], r["prob_ards"]] for r in rows])
            np.testing.assert_allclose(got, probs.numpy(), atol=1e-5, rtol=0)
            assert votes
    assert (tmp / "models" / "pf-fold1.scaling.json").exists()


@pytest.mark.parametrize("over", [
    dict(kfolds=None, holdout_set_type="main"),
    dict(network="cnn_regressor"),
])
def test_parallel_folds_refuses_what_the_jax_package_refuses(
        synthetic_cohort, tmp_path, over):
    trainer = tloop.make_trainer(Configuration(overrides=_overrides(
        synthetic_cohort, tmp_path, **over)), device="cpu", verbose=False)
    with pytest.raises(ValueError, match="parallel_folds"):
        trainer.train_and_test()


@pytest.mark.parametrize("network,deterministic", [("cnn_linear", False),
                                                    ("cnn_lstm", True)])
def test_stacked_eval_draws_dropout_as_the_sequential_eval(
        synthetic_cohort, tmp_path, network, deterministic):
    """cnn_linear's eval draws dropout masks, cnn_lstm's runs with dropout
    off, as each network's sequential eval does (the JAX package's
    parallel eval draws them for every network)."""
    from types import SimpleNamespace

    trainer = ParallelFoldTrainer(Configuration(overrides=_overrides(
        synthetic_cohort, tmp_path, network=network,
        time_series_hidden_units=4)), device="cpu", verbose=False)
    trainer.n_sub_batches = S
    trainer.fold_train_idx = [np.arange(4)] * F
    trainer.scaling = [(np.zeros(1, np.float32), np.ones(1, np.float32))] * F
    ds = SimpleNamespace(dataset_type="unpadded_centered_sequences",
                         cache=SimpleNamespace(
                             data=np.zeros((4, S, 1, L), np.float32),
                             target=np.zeros((4, 2), np.float32)))
    runner = trainer.make_stacked_runner(trainer.new_stacked_state(F), ds)
    runner.inputs["data"].copy_(_t(windows(1, (F, 8, S, 1, L))))
    first = runner.eval()[1].clone()
    again = runner.eval()[1]
    assert first.shape[:2] == (F, 8)
    assert torch.equal(first, again) == deterministic
