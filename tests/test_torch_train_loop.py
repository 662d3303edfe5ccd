"""The slice as a whole on the CPU: the port's Trainer against the JAX
package's, on the same synthetic cohort.

Both run cnn_linear/densenet18 at S = 4, batch 8, 2 folds x 2 epochs,
float32, config 1's optimizer (clip 0.01, wd 1e-4, Nesterov SGD) at lr
1e-4 with minority oversampling, ``dp_devices: 1``.  At config 1's lr
1e-3 this tiny run is chaotic: a 1e-7 relative change of the init moves
the port's own losses far more than at 1e-4, where it stays under 1e-5
(``test_comparison_lr_is_well_conditioned``).  Dropout is off on both
sides (each ``make_train_step`` is wrapped), and each fold of the port
starts from the params the JAX trainer initialised for that fold, carried
over with ``transplant``.  Per-step losses agree to 1e-4; patient rows
(votes, prediction, pred_frac) and per-fold AUCs are equal.  No window's
two logits lie within 1e-4 of a tie, so a vote cannot flip on rounding.
Then the port alone: its device-cache and host epochs agree, a saved
fold checkpoint restores and serves, options it lacks raise.
"""
import numpy as np
import pytest
import torch

import deepards_tpu.train.loop as jloop
import deepards_tpu_torch.train.loop as tloop
from deepards_tpu.config import Configuration as JaxConfiguration
from deepards_tpu.data.dataset import ARDSRawDataset as JaxDataset
from deepards_tpu_torch.cli import serve as tserve
from deepards_tpu_torch.config.config import Configuration
from deepards_tpu_torch.data.dataset import ARDSRawDataset
from deepards_tpu_torch.data.pipeline import BatchPipeline
from deepards_tpu_torch.train import checkpoint
from deepards_tpu_torch.transplant import transplant

# parallel test workers share the cores: one torch thread each
torch.set_num_threads(1)

TIE = 1e-4


def _overrides(cohort, tmp_path, **over):
    base = dict(
        data_path=cohort["data_path"], cohort_file=cohort["cohort_file"],
        experiment_num=1, network="cnn_linear", base_network="densenet18",
        dataset_type="unpadded_centered_sequences", n_sub_batches=4,
        kfolds=2, epochs=2, batch_size=8, optimizer="sgd",
        learning_rate=0.0001, weight_decay=0.0001, clip_grad=True,
        clip_val=0.01, oversample_minority=True, compute_dtype="float32",
        dp_devices=1, results_dir=str(tmp_path / "results"), seed=7,
    )
    base.update(over)
    return base


def _no_dropout(make_train_step):
    def wrapped(*args, **kw):
        kw["dropout_active"] = False
        kw["eval_dropout_active"] = False
        return make_train_step(*args, **kw)
    return wrapped


@pytest.fixture(scope="module")
def jax_run(synthetic_cohort, tmp_path_factory):
    """The JAX trainer's run and the params it initialised per fold."""
    tmp = tmp_path_factory.mktemp("jax")
    inits = []
    create = jloop.create_train_state

    def recording(*args, **kw):
        state = create(*args, **kw)
        inits.append(transplant(
            {k: np.asarray(v) for k, v in _flat(state.params).items()}))
        return state

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jloop, "create_train_state", recording)
        mp.setattr(jloop, "make_train_step",
                   _no_dropout(jloop.make_train_step))
        trainer = jloop.Trainer(JaxConfiguration(
            overrides=_overrides(synthetic_cohort, tmp)), verbose=False)
        results = trainer.train_and_test()
    return results, inits


def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        key = prefix + k
        if hasattr(v, "items"):
            out.update(_flat(v, key + "/"))
        else:
            out[key] = v
    return out


def _port_trainer(cohort, tmp_path, inits=None, **over):
    trainer = tloop.Trainer(Configuration(
        overrides=_overrides(cohort, tmp_path, **over)), device="cpu",
        verbose=False)
    trainer.eval_logits = []
    record = trainer._record_eval

    def recording(losses, outs, *args):
        trainer.eval_logits.append(outs)
        return record(losses, outs, *args)

    trainer._record_eval = recording
    if inits is not None:
        trainer.init_model = lambda model, fold: model.load_state_dict(
            inits[fold])
    return trainer


@pytest.fixture(scope="module")
def port_run(synthetic_cohort, tmp_path_factory, jax_run):
    _, inits = jax_run
    tmp = tmp_path_factory.mktemp("port")
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(tloop, "make_train_step",
                   _no_dropout(tloop.make_train_step))
        trainer = _port_trainer(synthetic_cohort, tmp, inits,
                                save_model="m.pt",
                                saved_models_dir=str(tmp / "models"))
        trainer.train_and_test()
    return trainer


def _meters(results, prefix):
    return {k: v.values for k, v in results.reporting.meters.items()
            if k.startswith(prefix)}


def test_losses_match_jax(jax_run, port_run):
    jres, _ = jax_run
    for prefix in ("loss_epoch_", "test_loss_fold_"):
        got, want = _meters(port_run.results, prefix), _meters(jres, prefix)
        assert got.keys() == want.keys() and got
        for name in want:
            np.testing.assert_allclose(got[name], want[name], atol=1e-4,
                                       rtol=0, err_msg=name)


def test_no_logit_tie(port_run):
    for logits in port_run.eval_logits:
        assert np.abs(logits[:, 0] - logits[:, 1]).min() > TIE


def test_patient_rows_and_auc_equal_jax(jax_run, port_run):
    jres, _ = jax_run
    want = jres.results.to_dict(orient="records")
    got = port_run.results.results
    assert len(got) == len(want) == 2 * 2 * 4
    for a, b in zip(got, want):
        assert a.keys() == b.keys()
        for key in a:
            assert a[key] == b[key], key
    for fold in (0, 1):
        auc = port_run.results.get_meter("test_auc", fold).values
        assert auc == jres.get_meter("test_auc", fold).values
        assert len(auc) == 2


def test_comparison_lr_is_well_conditioned(synthetic_cohort, tmp_path):
    """A 1e-7 relative nudge of the init moves the port's own losses by
    under 1e-5 at lr 1e-4 (the comparison's), and by over 10x more at
    config 1's lr 1e-3."""

    def losses(lr, nudge):
        trainer = _port_trainer(synthetic_cohort, tmp_path, epochs=1,
                                only_fold=0, learning_rate=lr)
        init = trainer.init_model

        def nudged(model, fold):
            init(model, fold)
            gen = torch.Generator().manual_seed(3)
            with torch.no_grad():
                for p in model.parameters():
                    p.mul_(1 + nudge * torch.randn(p.shape, generator=gen))

        trainer.init_model = nudged
        with pytest.MonkeyPatch.context() as mp:
            mp.setattr(tloop, "make_train_step",
                       _no_dropout(tloop.make_train_step))
            trainer.train_and_test()
        return np.asarray(trainer.results.get_meter("loss", 0).values)

    drift = {lr: np.abs(losses(lr, 0.0) - losses(lr, 1e-7)).max()
             for lr in (1e-4, 1e-3)}
    assert drift[1e-4] < 1e-5
    assert drift[1e-3] > 10 * drift[1e-4]


def test_device_cache_and_host_epochs_agree(synthetic_cohort, tmp_path):
    """Same seed, dropout on: the default (device-cache) epoch and the
    host epoch give the same losses and records."""
    runs = []
    for flag in (None, False):
        trainer = _port_trainer(synthetic_cohort, tmp_path / str(flag),
                                kfolds=2, epochs=1, only_fold=1,
                                device_cache=flag)
        assert trainer._device_cache_eligible(SmallCache()) is (
            flag is None)
        trainer.train_and_test()
        runs.append(trainer.results)
    device, host = runs
    for prefix in ("loss_fold_", "test_loss_fold_"):
        got, want = _meters(host, prefix), _meters(device, prefix)
        assert got.keys() == want.keys() and got
        for name in want:
            np.testing.assert_allclose(got[name], want[name], atol=1e-6,
                                       rtol=0)
    assert host.results == device.results
    assert [{k: v for k, v in r.items()} for r in host.all_pred_to_hour] \
        == device.all_pred_to_hour


class SmallCache:
    """A dataset stand-in with a small cache, for the eligibility rule."""

    class cache:
        data = np.zeros(4, np.float32)


def test_checkpoints_restore_and_serve(port_run, synthetic_cohort):
    """Each fold's checkpoint has its scaling sidecar and the full state;
    served deterministically it gives the trainer's final logits."""
    models = port_run.conf.get("saved_models_dir")
    state = port_run.final_state
    path = "{}/m-fold1".format(models)
    for fold in (0, 1):
        assert checkpoint.load_scaling("{}/m-fold{}".format(models, fold))
    saved = checkpoint.restore(path)
    assert saved["step"] == state.step > 0
    for k, v in state.model.state_dict().items():
        assert torch.equal(saved["params"][k], v)
    restored = port_run.restore_state(port_run.new_state(1), path)
    assert torch.equal(restored.generator.get_state(),
                       state.generator.get_state())
    assert restored.step == state.step
    want_opt = state.optimizer.state_dict()["state"]
    got_opt = restored.optimizer.state_dict()["state"]
    for k in want_opt:
        assert torch.equal(got_opt[k]["momentum_buffer"],
                           want_opt[k]["momentum_buffer"])

    # train -> serve: same normalized batch, dropout off on both sides
    scaling = checkpoint.load_scaling(path)
    np.testing.assert_array_equal(scaling[0], port_run._current_scaling[0])
    engine = tserve.InferenceEngine(path, n_sub_batches=4, batch_size=8,
                                    scaling=scaling, bn_scope="batch",
                                    device="cpu")
    ds = ARDSRawDataset(
        synthetic_cohort["data_path"], 1, synthetic_cohort["cohort_file"], 4,
        "unpadded_centered_sequences", kfold_num=1, total_kfolds=2,
        oversample_minority=True, seed=7)
    x = torch.from_numpy(ds.cache.data[:8])
    pipe = BatchPipeline(ds, "cpu")
    with torch.no_grad():
        want = state.model(pipe(x), True)
        got = engine.model((x - engine._mu) / engine._std, True)
    np.testing.assert_allclose(got.numpy(), want.numpy(), atol=1e-5, rtol=0)


def test_serve_scaling_pickle_from_a_jax_dataset(synthetic_cohort,
                                                 port_run, tmp_path,
                                                 monkeypatch):
    """--scaling-pickle reads a dataset the JAX package saved; the served
    engine uses its first fold's factors."""
    jds = JaxDataset(synthetic_cohort["data_path"], 1,
                     synthetic_cohort["cohort_file"], 4,
                     "unpadded_centered_sequences", kfold_num=0,
                     total_kfolds=2)
    saved = jds.save(str(tmp_path / "cohort.npz"))
    served = {}

    class Server:
        def serve_forever(self):
            pass

    def fake_serve(engine, host, port):
        served["engine"] = engine
        return Server()

    monkeypatch.setattr(tserve, "serve", fake_serve)
    # fold 1's checkpoint: its sidecar holds other factors than fold 0's
    path = "{}/m-fold1".format(port_run.conf.get("saved_models_dir"))
    tserve.main([path, "--n-sub-batches", "4", "--batch-size", "2",
                 "--device", "cpu", "--scaling-pickle", saved])
    mu, std = served["engine"].scaling
    want_mu, want_std = jds.scaling_factors[0]
    np.testing.assert_array_equal(mu, want_mu)
    np.testing.assert_array_equal(std, want_std)
    assert not np.array_equal(mu, checkpoint.load_scaling(path)[0])


def test_resume_from_an_epoch_checkpoint(synthetic_cohort, tmp_path):
    """A checkpoint saved after fold 1's first epoch resumes at fold 1's
    second epoch, from the saved state, skipping fold 0."""
    models = str(tmp_path / "models")
    first = _port_trainer(synthetic_cohort, tmp_path / "a", only_fold=1,
                          save_model="m.pt", save_model_per_epoch=True,
                          saved_models_dir=models)
    first.train_and_test()
    path = models + "/m-epoch1-fold1"
    meta = checkpoint.load_resume_meta(path)
    assert {k: meta[k] for k in ("fold", "epoch", "next_batch")} == {
        "fold": 1, "epoch": 2, "next_batch": 0}
    assert meta["host_rng"]["bit_generator"] == "PCG64"
    saved_step = checkpoint.restore(path)["step"]
    resumed = _port_trainer(synthetic_cohort, tmp_path / "b",
                            load_checkpoint=path)
    resumed.train_and_test()
    epochs = {(r["fold_num"], r["epoch_num"]) for r in resumed.results.results}
    assert epochs == {(1, 2)}
    per_epoch = len(first.results.get_meter("loss_epoch_2", 1).values)
    assert resumed.final_state.step == saved_step + per_epoch


@pytest.mark.parametrize("option", [
    dict(model_devices=2),
    dict(network="cnn_regressor", plot_tiled_disease_evol=True),
])
def test_unported_options_raise(synthetic_cohort, tmp_path, option):
    with pytest.raises(NotImplementedError):
        _port_trainer(synthetic_cohort, tmp_path, **option)


@pytest.mark.parametrize("over,error", [
    (dict(network="cnn_linear_2d", parallel_folds=True), NotImplementedError),
    (dict(network="siamese_cnn_transformer"), ValueError),
    (dict(network="siamese_cnn_linear", load_siamese="s.pt"), ValueError),
    (dict(network="autoencoder", perform_dtw_preprocessing=True),
     NotImplementedError),
    (dict(network="siamese_pretrained", load_siamese="s.pt"), ValueError),
])
def test_other_trainers_raise(synthetic_cohort, tmp_path, over, error):
    """What ``make_trainer`` refuses: parallel folds of a 2D network,
    folds for a siamese network, ``--load-siamese``, an option not ported
    yet."""
    with pytest.raises(error):
        tloop.make_trainer(Configuration(
            overrides=_overrides(synthetic_cohort, tmp_path, **over)),
            device="cpu")
