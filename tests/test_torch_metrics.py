"""The port's metrics against the JAX package and scikit-learn: AUC (ties,
one class), patient votes (a tied vote is class 0), aggregate stats,
maximals and predictions by hour, on the same seeded predictions."""
import json
import math

import numpy as np
import pandas as pd
import pytest
from sklearn.metrics import roc_auc_score

from deepards_tpu.eval.metrics import DeepARDSResults as JaxResults
from deepards_tpu_torch.data.dataset import GroundTruth
from deepards_tpu_torch.eval.metrics import (
    DeepARDSResults,
    aggregate_stats,
    roc_auc,
)


@pytest.mark.parametrize("seed", range(6))
def test_auc_equals_roc_auc_score_with_ties(seed):
    rng = np.random.default_rng(seed)
    n = int(rng.integers(4, 40))
    y = rng.integers(0, 2, size=n)
    y[:2] = [0, 1]
    scores = rng.integers(0, 5, size=n) / 4.0  # many ties
    assert roc_auc(y, scores) == pytest.approx(roc_auc_score(y, scores),
                                               abs=1e-15)
    assert round(roc_auc(y, scores), 4) == round(roc_auc_score(y, scores), 4)


def test_auc_is_nan_with_one_class():
    assert math.isnan(roc_auc([1, 1, 1], [0.1, 0.5, 0.9]))
    assert math.isnan(roc_auc([0, 0], [0.1, 0.5]))
    rows = [{"patho": 1, "prediction": 1, "pred_frac": 0.7}]
    stats = aggregate_stats(rows, 0, 1)
    assert all(math.isnan(s["auc"]) for s in stats)


def _truth(rng, n_patients=6, per_patient=7):
    patients = np.repeat(["p{}".format(i) for i in range(n_patients)],
                         per_patient)
    y = np.repeat(np.arange(n_patients) % 2, per_patient)
    index = rng.permutation(len(patients) * 3)[:len(patients)]
    hour = rng.uniform(0, 24, size=len(patients)).astype(np.float32)
    return GroundTruth(index=index, patient=patients, y=y, hour=hour)


def _jax_frame(truth):
    return pd.DataFrame({"patient": truth.patient, "y": truth.y,
                         "hour": truth.hour}, index=truth.index)


def _records(frame):
    return [{k: v.item() if isinstance(v, np.generic) else v
             for k, v in row.items()}
            for row in frame.to_dict(orient="records")]


def test_votes_stats_and_maximals_equal_jax(tmp_path):
    rng = np.random.default_rng(0)
    port = DeepARDSResults("0", None, results_dir=str(tmp_path / "port"))
    jax = JaxResults("0", None, results_dir=str(tmp_path / "jax"))
    for fold in range(2):
        truth = _truth(rng)
        hours = {int(i): np.array([h, h + 0.1])
                 for i, h in zip(truth.index, truth.hour)}
        for epoch in (1, 2, 3):
            preds = rng.integers(0, 2, size=len(truth.index))
            order = np.argsort(truth.index)
            idx, p = truth.index[order], preds[order]
            stats = port.perform_patient_predictions(
                truth, idx, p, fold, epoch, verbose=False)
            series = pd.Series(p, index=idx)
            jstats = jax.perform_patient_predictions(
                _jax_frame(truth), series, fold, epoch, verbose=False)
            assert stats == _records(jstats)
            port.save_predictions_by_hour(truth, idx, p, hours, epoch, fold)
            jax.save_predictions_by_hour(_jax_frame(truth), series, hours,
                                         epoch, fold)
    assert port.results == _records(jax.results)
    got_hours = [{k: v for k, v in r.items() if k != "index"}
                 for r in port.all_pred_to_hour]
    want_hours = _records(jax.all_pred_to_hour)
    assert len(got_hours) == len(want_hours)
    for a, b in zip(got_hours, want_hours):
        assert a["pred"] == b["pred"] and a["patient"] == b["patient"]
        assert a["y"] == b["y"] and (a["epoch"], a["fold"]) == (
            b["epoch"], b["fold"])
        assert a["hour"] == pytest.approx(b["hour"], abs=1e-6)
    for name in port.reporting.meters:
        assert port.reporting.meters[name].values == pytest.approx(
            jax.reporting.meters[name].values, nan_ok=True)
    agg = port.aggregate_classification_results(verbose=False)
    jagg = jax.aggregate_classification_results(verbose=False)
    assert agg == _records(jagg)
    maximals = port.save_maximals(str(tmp_path / "max.json"), agg, False)
    jmax = jax.save_maximals(str(tmp_path / "max.pkl"), jagg, False)
    assert maximals == _records(jmax)
    port.save_all()
    results = list((tmp_path / "port").glob("*_results_*.json"))
    assert len(results) == 1
    saved = json.loads(results[0].read_text())
    assert saved["results"] == port.results


def test_tied_vote_goes_to_class_zero(tmp_path):
    res = DeepARDSResults("0", None, results_dir=str(tmp_path))
    truth = GroundTruth(index=np.arange(4), patient=np.array(["a"] * 4),
                        y=np.ones(4, int), hour=np.zeros(4, np.float32))
    res.perform_patient_predictions(truth, np.arange(4),
                                    np.array([1, 0, 1, 0]), 0, 1, False)
    row = res.results[0]
    assert row["prediction"] == 0 and row["pred_frac"] == 0.5
    assert row["ARDS_votes"] == 2 and row["OTHER_votes"] == 2


def test_maximals_take_the_first_epoch_with_the_max_auc(tmp_path):
    res = DeepARDSResults("0", None, results_dir=str(tmp_path))
    agg = []
    for epoch, auc in ((1, 0.5), (2, 0.75), (3, 0.75), (4, float("nan"))):
        for patho in ("OTHER", "ARDS"):
            agg.append({"patho": patho, "auc": auc, "fold_num": 0,
                        "epoch_num": epoch})
    agg += [{"patho": p, "auc": float("nan"), "fold_num": 1, "epoch_num": e}
            for e in (1, 2) for p in ("OTHER", "ARDS")]
    maximals = res.save_maximals(str(tmp_path / "m.json"), agg, False)
    assert [(r["fold_num"], r["epoch_num"]) for r in maximals] == [
        (0, 2), (0, 2), (1, 2), (1, 2)]
