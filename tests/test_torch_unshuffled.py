"""Config 4 with ``--unshuffled``: cnn_lstm's stateful fold on the CPU.

- A 2-fold run against the JAX package's ``_run_stateful_fold``
  (``deepards_tpu/train/loop.py:754-987``) on the shared synthetic
  cohort: cnn_lstm over resnet18 at 8 initial planes (no dropout), S = 4,
  float32, lr 1e-4, no oversampling, each fold of the port from the params
  the JAX trainer initialised.  Per-step train and test losses within
  1e-4; the per-breath predictions by hour (each window's index repeated S
  times), votes, patient rows and AUCs equal.
- The JAX package's fault, pinned: with ``oversample_minority`` (config
  4's yml sets it) its device-cache stateful epoch looks the patients up
  by window index (``gt.loc[order]``, ``deepards_tpu/train/loop.py:872``),
  which the oversampled windows repeat, and fails; the port's epoch reads
  them in order and trains.
- The carry is reset exactly where the patient changes: the reset flags an
  epoch feeds the step are the ground truth's patient boundaries, a window
  after a reset scores as it does alone, and one after a carried state
  does not.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_configs_2_3_4 import (
    PLANES,
    _hour_rows,
    _meters,
    _overrides,
    random_params,
)

import deepards_tpu.train.loop as jloop
import deepards_tpu_torch.train.loop as tloop
from deepards_tpu.config import Configuration as JaxConfiguration
from deepards_tpu.train import steps as jsteps
from deepards_tpu_torch.config.config import Configuration
from deepards_tpu_torch.transplant import transplant

# parallel test workers share the cores: one torch thread each
torch.set_num_threads(1)

RUN = dict(network="cnn_lstm", base_network="resnet18",
           initial_planes=PLANES, time_series_hidden_units=16,
           dataset_type="unpadded_centered_sequences", unshuffled=True,
           oversample_minority=False)


def _runs(cohort, tmp_path, **over):
    inits = []

    def numpy_init(model, tx, sample, rng, has_metadata=False,
                   rng_impl=None):
        params = random_params(model, len(inits),
                               jnp.asarray(sample["data"]), None, True)
        inits.append(transplant(params))
        return jsteps.TrainState(
            params=params, opt_state=tx.init(params),
            rng=jsteps.make_state_rng(rng, rng_impl),
            step=jnp.zeros((), jnp.int32))

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jloop, "create_train_state", numpy_init)
        jres = jloop.Trainer(JaxConfiguration(overrides=_overrides(
            cohort, tmp_path / "jax", **{**RUN, **over})), verbose=False
        ).train_and_test()
    trainer = tloop.make_trainer(Configuration(overrides=_overrides(
        cohort, tmp_path / "port", **{**RUN, **over})), device="cpu",
        verbose=False)
    runs = iter(inits)
    trainer.init_model = lambda model, fold: model.load_state_dict(
        next(runs))
    trainer.train_and_test()
    return jres, trainer


def test_unshuffled_run_matches_jax(synthetic_cohort, tmp_path):
    jres, trainer = _runs(synthetic_cohort, tmp_path)
    port = trainer.results
    for prefix in ("loss_fold_", "test_loss_fold_"):
        got, want = _meters(port, prefix), _meters(jres, prefix)
        assert got.keys() == want.keys() and got
        for key in want:
            np.testing.assert_allclose(got[key], want[key], atol=1e-4,
                                       rtol=0, err_msg=key)
    # one train step a window, in the ground truth's order
    assert not _meters(port, "loss_epoch_")
    want = jres.results.to_dict(orient="records")
    assert port.results == want and len(want) == 2 * 4
    for fold in (0, 1):
        assert port.get_meter("test_auc", fold).values == \
            jres.get_meter("test_auc", fold).values
    hours = jres.all_pred_to_hour.to_dict(orient="records")
    assert _hour_rows(port.all_pred_to_hour) == _hour_rows(hours)
    assert trainer.last_eval["logits"].shape[1:] == (4, 2)
    assert sum(r["fold"] == 1 for r in port.all_pred_to_hour) == 4 * len(
        trainer.last_eval["index"])


def test_carry_resets_at_patient_changes(synthetic_cohort, tmp_path):
    """The resets an epoch feeds are the patient boundaries; a reset
    window's logits are its own, a carried one's are not."""
    trainer = tloop.make_trainer(Configuration(overrides=_overrides(
        synthetic_cohort, tmp_path, only_fold=0, **RUN)), device="cpu",
        verbose=False)
    train_ds, test_ds = trainer.get_base_datasets()
    test_ds.set_kfold_indexes_for_fold(0)
    train_ds.set_kfold_indexes_for_fold(0)
    state = trainer.new_state(0)
    runner = trainer.make_stateful_runner(state, train_ds)
    fed = []
    evaluate = runner.eval

    def recording():
        fed.append(float(runner.inputs["reset"]))
        return evaluate()

    runner.eval = recording
    trainer.run_stateful_epoch(runner, test_ds, False, 0, 1)
    truth = test_ds.get_ground_truth()
    want = np.r_[True, truth.patient[1:] != truth.patient[:-1]]
    assert np.array_equal(np.asarray(fed, bool), want)
    assert 1 < want.sum() < len(want)
    logits = trainer.last_eval["logits"]
    for i in (np.flatnonzero(want)[1], np.flatnonzero(~want)[0]):
        runner.inputs["reset"].fill_(1.0)
        for key, table in trainer._get_device_cache(test_ds).items():
            runner.inputs[key].copy_(torch.from_numpy(
                table.numpy()[truth.index[i]][None]))
        _, alone = evaluate()
        same = np.allclose(alone[0].numpy(), logits[i], atol=1e-6, rtol=0)
        assert same == bool(want[i]), i


def test_jax_stateful_fold_fails_on_oversampled_windows(synthetic_cohort,
                                                        tmp_path):
    with pytest.raises(ValueError, match="could not broadcast"):
        _runs(synthetic_cohort, tmp_path, oversample_minority=True)
    trainer = tloop.make_trainer(Configuration(overrides=_overrides(
        synthetic_cohort, tmp_path / "port", only_fold=0,
        **{**RUN, "oversample_minority": True})), device="cpu",
        verbose=False)
    trainer.train_and_test()
    losses = trainer.results.get_meter("loss", 0).values
    assert len(losses) == trainer.last_train_count and np.isfinite(
        losses).all()
