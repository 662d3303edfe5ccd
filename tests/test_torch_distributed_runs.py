"""Runs at ``dp_devices=2`` in one process, the port against the JAX
package, whose mesh then spans 2 of the 8 forced CPU devices: the port's
``Trainer`` with batch 5 (padded to 6) over the device-cache epoch and
with batch 7 (each batch padded to 8) over the host epoch, as in
``test_torch_train_jax_runs.py`` (per-step losses within 1e-4, patient
rows and AUC equal), and ``cli.evaluate`` at ``dp_devices: 2`` with batch
5, as in ``test_torch_results_cli.py`` (the fold table equal, AUC within
1e-6).  At batch 5 the host epoch is ill-conditioned at dp 1 already (a
clamped gradient element near +-0.01 parts the two frameworks by ~1e-4
within 22 steps), hence batch 7 there.
"""
import pytest
import torch
from test_torch_patient_gradcam import cnn_linear, save_cohort
from test_torch_results_cli import (
    _no_dropout,
    mean_results_table,
    save_params,
    write_yml,
)
from test_torch_train_jax_runs import _assert_runs_equal, _jax_run, _port_run

import deepards_tpu.train.steps as jsteps
import deepards_tpu_torch.train.steps as tsteps
from deepards_tpu.cli import evaluate as jevaluate
from deepards_tpu_torch.cli import evaluate

torch.set_num_threads(1)


@pytest.mark.parametrize("over,steps", [
    (dict(batch_size=5), 18),
    (dict(batch_size=7, device_cache=False, fused_steps=1), 16),
])
def test_dp2_run_matches_jax(synthetic_cohort, tmp_path, over, steps):
    """108 train windows: the device-cache epoch in batches of 6 (5 padded
    for the axis), the host epoch in batches of 7 each padded to 8."""
    over = dict(over, dp_devices=2, epochs=1)
    jres, inits, _ = _jax_run(synthetic_cohort, tmp_path / "jax", **over)
    port, _ = _port_run(synthetic_cohort, tmp_path / "port", inits, **over)
    _assert_runs_equal(port, jres, epochs=1)
    assert len(port.get_meter("loss", 1).values) == steps


def test_evaluate_dp2_matches_jax(tmp_path, capsys, monkeypatch):
    data = save_cohort(str(tmp_path), total_kfolds=2)
    models_dir = str(tmp_path / "models")
    for fold in (0, 1):
        _, params, _ = cnn_linear(seed=10 + fold)
        save_params(models_dir, "f{}".format(fold), params)
    common = dict(train_from_pickle=data, network="cnn_linear",
                  base_network="densenet18", n_sub_batches=3, batch_size=5,
                  kfolds=2, compute_dtype="float32", dp_devices=2)
    monkeypatch.setattr(jsteps, "make_train_step",
                        _no_dropout(jsteps.make_train_step))
    monkeypatch.setattr(tsteps, "make_train_step",
                        _no_dropout(tsteps.make_train_step))
    jevaluate.main(["-co", write_yml(
        str(tmp_path / "jax.yml"), results_dir=str(tmp_path / "jax"),
        models={0: ["f0"], 1: ["f1"]}, **common),
        "--saved-models-dir", models_dir])
    want = mean_results_table(capsys.readouterr().out)
    rows, _, trainer = evaluate.main(["-co", write_yml(
        str(tmp_path / "port.yml"), results_dir=str(tmp_path / "port"),
        models={0: ["f0.npz"], 1: ["f1.npz"]}, device="cpu", **common),
        "--saved-models-dir", models_dir])
    assert trainer.batch_rows() == (6, 6)
    assert [(r["Fold"], r["Accuracy"]) for r in rows] == [
        (w["Fold"], w["Accuracy"]) for w in want]
    for got, want_row in zip(rows, want):
        assert abs(got["AUC"] - want_row["AUC"]) <= 1e-6
