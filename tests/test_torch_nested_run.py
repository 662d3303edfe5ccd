"""Whole runs of the nested trainer against the JAX package's
``NestedTrainer`` (``deepards_tpu/train/nested_trainer.py``).

cnn_to_nested_transformer over resnet18 at 8 initial planes (no dropout),
S = 4, 2 folds x 1 epoch of a small synthetic cohort at lr 1e-4, float32,
each fold of the port from the params the JAX trainer initialised (taken
where it builds its ``TrainState``).  The JAX trainer applies the model
with ``deterministic`` False in training and eval alike, so the
transformer's dropout (0.2, fixed in ``Block``) is set to 0 on both sides
by a monkeypatch.  Per-step train and test losses within 1e-4; votes,
patient rows, AUCs and predictions by hour equal
(``test_torch_nested_last_breath.py`` runs ``loss_calc: last_breath``).
"""
import functools

import jax
import numpy as np
import pytest
import torch

import deepards_tpu.models.nested as jnested
import deepards_tpu.train.nested_trainer as jnested_trainer
import deepards_tpu_torch.models.nested as tnested
from deepards_tpu.config import Configuration as JaxConfiguration
from deepards_tpu.models import transformer as jtransformer
from deepards_tpu.train.loop import make_trainer as jax_make_trainer
from deepards_tpu_torch.config.config import Configuration
from deepards_tpu_torch.data.synthetic import generate_cohort
from deepards_tpu_torch.models import transformer as ttransformer
from deepards_tpu_torch.train.loop import make_trainer
from deepards_tpu_torch.transplant import transplant

# parallel test workers share the cores: one torch thread each
torch.set_num_threads(1)


@pytest.fixture(scope="module")
def cohort(tmp_path_factory):
    """8 patients of 60 breaths: 15 windows each at S = 4 (buckets 16 and,
    oversampled, 32)."""
    data_path = str(tmp_path_factory.mktemp("nested_run"))
    cohort_file = generate_cohort(data_path, n_patients=8,
                                  n_breaths_per_patient=60, seed=13)
    return {"data_path": data_path, "cohort_file": cohort_file}


def _overrides(cohort, tmp_path, **over):
    base = dict(
        data_path=cohort["data_path"], cohort_file=cohort["cohort_file"],
        experiment_num=1, network="cnn_to_nested_transformer",
        base_network="resnet18", initial_planes=8,
        dataset_type="unpadded_centered_sequences", n_sub_batches=4,
        kfolds=2, epochs=1, batch_size=4, learning_rate=0.0001,
        weight_decay=0.0001, clip_grad=True, clip_val=0.01,
        oversample_minority=True, compute_dtype="float32", dp_devices=1,
        results_dir=str(tmp_path / "results"), seed=7)
    base.update(over)
    return base


def _runs(cohort, tmp_path, **over):
    """The JAX trainer's results and the port's trainer, each fold of the
    port from the params of the JAX trainer's fold."""
    inits = []
    state_cls = jnested_trainer.TrainState

    def capture(**fields):
        inits.append(transplant(jax.tree_util.tree_map(np.asarray,
                                                       fields["params"])))
        return state_cls(**fields)

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jnested_trainer, "TrainState", capture)
        mp.setattr(jnested, "Transformer", functools.partial(
            jtransformer.Transformer, dropout=0.0))
        mp.setattr(tnested, "Transformer", functools.partial(
            ttransformer.Transformer, dropout=0.0))
        jres = jax_make_trainer(JaxConfiguration(overrides=_overrides(
            cohort, tmp_path / "jax", **over)), verbose=False
        ).train_and_test()
        trainer = make_trainer(Configuration(overrides=_overrides(
            cohort, tmp_path / "port", **over)), device="cpu", verbose=False)
        runs = iter(inits)
        trainer.init_model = lambda model, fold: model.load_state_dict(
            next(runs))
        trainer.train_and_test()
    return jres, trainer


def _hour_rows(rows):
    return sorted((r["patient"], r["y"], round(float(r["hour"]), 4),
                   r["pred"], r["epoch"], r["fold"]) for r in rows)


def _assert_run_matches(jres, trainer, folds):
    port = trainer.results
    for prefix in ("loss_fold_", "test_loss_fold_"):
        got = {k: v.values for k, v in port.reporting.meters.items()
               if k.startswith(prefix)}
        want = {k: v.values for k, v in jres.reporting.meters.items()
                if k.startswith(prefix)}
        assert got.keys() == want.keys() and len(got) == len(folds)
        for key in want:
            assert len(got[key]) == len(want[key]) > 0, key
            np.testing.assert_allclose(got[key], want[key], atol=1e-4,
                                       rtol=0, err_msg=key)
    want = jres.results.to_dict(orient="records")
    assert port.results == want and want
    for fold in folds:
        assert port.get_meter("test_auc", fold).values == \
            jres.get_meter("test_auc", fold).values
    hours = jres.all_pred_to_hour.to_dict(orient="records")
    assert _hour_rows(port.all_pred_to_hour) == _hour_rows(hours)


def test_nested_transformer_run_matches_jax(cohort, tmp_path):
    jres, trainer = _runs(cohort, tmp_path)
    _assert_run_matches(jres, trainer, (0, 1))
    # one test loss a patient, one prediction a real window
    assert trainer.last_eval["logits"].shape == (
        len(trainer.last_eval["index"]), 2)
