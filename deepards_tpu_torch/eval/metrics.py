"""Metrics and results: meters, patient-level votes, AUC.

Counterpart of ``deepards_tpu/eval/metrics.py`` on numpy, scipy and the
standard library (no pandas, no scikit-learn): append-only meters, the
``DeepARDSResults`` run store with per-patient TP/FP/TN/FN/vote rows,
majority-vote patient predictions (a tied vote goes to class 0), the
``pred_frac`` ARDS-vote fraction, patient-level ROC-AUC, max-AUC
"maximals" tables and predictions by hour.  Tables are lists of row dicts
under the JAX package's column names, and are written as JSON.
"""
import json
import math
import os
import uuid

import numpy as np
from scipy.stats import rankdata

PATHOS = {0: "OTHER", 1: "ARDS"}

RESULT_COLUMNS = ["patient", "patho"]
for _patho in PATHOS.values():
    RESULT_COLUMNS += ["{}_{}".format(_patho, k)
                       for k in ("tps", "fps", "tns", "fns", "votes")]
RESULT_COLUMNS += ["prediction", "pred_frac", "epoch_num", "fold_num"]

STAT_COLUMNS = [
    "patho", "tps", "tns", "fps", "fns", "accuracy", "sensitivity",
    "specificity", "precision", "auc", "f1", "fold_num", "epoch_num",
]


class Meter:
    """Append-only series with running mean."""

    def __init__(self, name):
        self.name = name
        self.values = []

    def update(self, value):
        self.values.append(float(value))

    @property
    def mean(self):
        return float(np.mean(self.values)) if self.values else 0.0

    def __len__(self):
        return len(self.values)

    def __repr__(self):
        return "{}: n={} mean={:.4f}".format(
            self.name, len(self.values), self.mean
        )


class Reporting:
    """Registry of meters persisted under a results dir."""

    def __init__(self, results_dir, suffix):
        self.results_dir = results_dir
        self.suffix = suffix
        self.meters = {}

    def does_meter_exist(self, name):
        return name in self.meters

    def new_meter(self, name):
        self.meters[name] = Meter(name)

    def update(self, name, value):
        self.meters[name].update(value)

    def save_all(self):
        os.makedirs(self.results_dir, exist_ok=True)
        arrays = {
            name: np.asarray(m.values, dtype=np.float64)
            for name, m in self.meters.items()
        }
        path = os.path.join(
            self.results_dir, "meters_{}.npz".format(self.suffix)
        )
        np.savez(path, **arrays)
        return path


def roc_auc(y_true, scores):
    """Area under the ROC curve as the Mann-Whitney statistic, tied
    scores sharing their average rank (equal to scikit-learn's
    ``roc_auc_score``).  NaN when one class is missing."""
    y_true = np.asarray(y_true)
    scores = np.asarray(scores, np.float64)
    n_pos = int((y_true == 1).sum())
    n_neg = len(y_true) - n_pos
    if n_pos == 0 or n_neg == 0:
        return float("nan")
    rank_sum = rankdata(scores)[y_true == 1].sum()
    return float((rank_sum - n_pos * (n_pos + 1) / 2.0) / (n_pos * n_neg))


def roc_curve(y_true, scores):
    """(fpr, tpr, thresholds) of scikit-learn's ``roc_curve`` with its
    default ``drop_intermediate``: the points at each distinct score from
    the highest down, collinear points dropped, (0, 0) at threshold inf
    first."""
    y_true = np.asarray(y_true) == 1
    scores = np.asarray(scores, np.float64)
    order = np.argsort(scores, kind="mergesort")[::-1]
    scores, y_true = scores[order], y_true[order]
    cut = np.r_[np.flatnonzero(np.diff(scores)), len(scores) - 1]
    tps = np.cumsum(y_true, dtype=np.float64)[cut]
    fps = 1 + cut - tps
    thresholds = scores[cut]
    if len(fps) > 2:
        keep = np.flatnonzero(np.r_[True, np.logical_or(
            np.diff(fps, 2), np.diff(tps, 2)), True])
        fps, tps, thresholds = fps[keep], tps[keep], thresholds[keep]
    tps, fps = np.r_[0, tps], np.r_[0, fps]
    return fps / fps[-1], tps / tps[-1], np.r_[np.inf, thresholds]


def r2_score(y_true, y_pred):
    """Coefficient of determination over all outputs together, in
    float64: 1 - SS_res / SS_tot, 0.0 when the targets do not vary
    (reference: deepards_tpu/train/loop.py:67-72)."""
    y_true = np.asarray(y_true, np.float64)
    y_pred = np.asarray(y_pred, np.float64)
    ss_res = ((y_true - y_pred) ** 2).sum()
    ss_tot = ((y_true - y_true.mean(axis=0)) ** 2).sum()
    return float(1.0 - ss_res / ss_tot) if ss_tot else 0.0


def aggregate_stats(patient_results, fold_num, epoch_num):
    """Patient-level stats per patho, as rows of ``STAT_COLUMNS``
    (reference: deepards/metrics.py:317-351)."""
    patho = np.asarray([r["patho"] for r in patient_results])
    pred = np.asarray([r["prediction"] for r in patient_results])
    pred_frac = [r["pred_frac"] for r in patient_results]
    auc = roc_auc(patho, pred_frac) if len(patho) else float("nan")
    auc = auc if math.isnan(auc) else round(auc, 4)
    rows = []
    for n, name in PATHOS.items():
        tps = float(((patho == n) & (pred == n)).sum())
        tns = float(((patho != n) & (pred != n)).sum())
        fps = float(((patho != n) & (pred == n)).sum())
        fns = float(((patho == n) & (pred != n)).sum())
        accuracy = round((tps + tns) / max(tps + tns + fps + fns, 1), 4)
        sensitivity = round(tps / (tps + fns), 4) if tps + fns else 0
        specificity = round(tns / (tns + fps), 4) if tns + fps else 0
        precision = round(tps / (tps + fps), 4) if tps + fps else 0
        f1 = (
            round(2 * precision * sensitivity / (precision + sensitivity), 4)
            if precision + sensitivity
            else 0
        )
        rows.append(dict(zip(STAT_COLUMNS, [
            name, tps, tns, fps, fns, accuracy, sensitivity, specificity,
            precision, auc, f1, fold_num, epoch_num,
        ])))
    return rows


def _unique(values):
    """Distinct values in order of first appearance."""
    return list(dict.fromkeys(values))


class DeepARDSResults:
    """Run store keyed by start_time + uuid."""

    def __init__(self, start_time, experiment_name, results_dir="results",
                 **hyperparams):
        self.results = []  # rows of RESULT_COLUMNS
        self.results_dir = results_dir
        self.reporting = Reporting(
            results_dir, "deepards_start_{}".format(start_time)
        )
        self.hyperparams = dict(hyperparams)
        self.hyperparams["start_time"] = start_time
        self.uuid_name = uuid.uuid4()
        self.experiment_name = experiment_name
        # rows of pred, hour, patient, y, epoch, fold (and the window index)
        self.all_pred_to_hour = []

    # -- meters ---------------------------------------------------------------

    def update_meter(self, metric_name, fold_num, val):
        name = "{}_fold_{}".format(metric_name, fold_num)
        if not self.reporting.does_meter_exist(name):
            self.reporting.new_meter(name)
        self.reporting.update(name, val)

    def update_epoch_meter(self, metric_name, epoch_num, val):
        name = "{}_epoch_{}".format(metric_name, epoch_num)
        if not self.reporting.does_meter_exist(name):
            self.reporting.new_meter(name)
        self.reporting.update(name, val)

    def get_meter(self, metric_name, fold_num):
        name = "{}_fold_{}".format(metric_name, fold_num)
        if not self.reporting.does_meter_exist(name):
            self.reporting.new_meter(name)
        return self.reporting.meters[name]

    def update_loss(self, fold_num, loss):
        self.update_meter("loss", fold_num, loss)

    def update_accuracy(self, fold_num, accuracy):
        self.update_meter("test_accuracy", fold_num, accuracy)

    def update_r2(self, fold_num, r2):
        self.update_meter("test_r2", fold_num, r2)

    # -- patient predictions --------------------------------------------------

    def perform_patient_predictions(self, truth, pred_index, preds, fold_num,
                                    epoch_num, verbose=True):
        """Vote aggregation: per-patient confusion counts and majority vote
        (reference: deepards/metrics.py:572-626).

        truth: the dataset's ``GroundTruth`` (window index, patient, y);
        pred_index, preds: per-prediction window index and class (a
        per-breath head gives several predictions per window).
        """
        pred_index = np.asarray(pred_index)
        preds = np.asarray(preds)
        patients = truth.patients()
        for pt in patients:
            rows = truth.patient == pt
            patho_n = int(truth.y[rows][0])
            label_of = dict(zip(truth.index[rows].tolist(),
                                truth.y[rows].tolist()))
            mine = np.isin(pred_index, truth.index[rows])
            pt_pred = preds[mine]
            pt_actual = np.asarray([label_of[i]
                                    for i in pred_index[mine].tolist()])
            row = [pt, patho_n]
            votes = {}
            for n in PATHOS:
                tp = int(((pt_actual == n) & (pt_pred == n)).sum())
                fn = int(((pt_actual == n) & (pt_pred != n)).sum())
                fp = int(((pt_actual != n) & (pt_pred == n)).sum())
                tn = int(((pt_actual != n) & (pt_pred != n)).sum())
                votes[n] = int((pt_pred == n).sum())
                row += [tp, fp, tn, fn, votes[n]]
            total = sum(votes.values())
            pred_frac = votes[1] / total if total else 0.0
            # max keeps the first key on a tie: a tied vote is class 0
            patho_pred = int(max(votes, key=lambda k: votes[k]))
            row += [patho_pred, pred_frac, epoch_num, fold_num]
            self.results.append(dict(zip(RESULT_COLUMNS, row)))

        chunk = [r for r in self.results
                 if r["patient"] in patients and r["epoch_num"] == epoch_num
                 and r["fold_num"] == fold_num]
        stats = aggregate_stats(chunk, fold_num, epoch_num)
        by_patho = {s["patho"]: s for s in stats}
        self.update_meter("test_auc", fold_num, stats[0]["auc"])
        for patho in PATHOS.values():
            prow = by_patho[patho]
            suffix = patho.lower()
            self.update_meter(
                "test_prec_{}".format(suffix), fold_num, prow["precision"])
            self.update_meter(
                "test_sen_{}".format(suffix), fold_num, prow["sensitivity"])
            self.update_meter(
                "test_f1_{}".format(suffix), fold_num, prow["f1"])
        self.update_meter("test_patient_accuracy", fold_num,
                          by_patho["ARDS"]["accuracy"])
        if verbose:
            self.print_results_report(stats)
            self.print_misclassified(chunk)
        return stats

    def print_results_report(self, stats):
        print("---- Patient-level stats ----")
        _print_table(stats, ["patho", "accuracy", "sensitivity", "precision",
                             "auc", "f1", "fold_num", "epoch_num"])

    def print_misclassified(self, chunk):
        print("Misclassified Patients")
        _print_table(
            [r for r in chunk if r["patho"] != r["prediction"]],
            ["patient", "patho", "prediction"]
            + ["{}_votes".format(p) for p in PATHOS.values()])

    # -- aggregation ----------------------------------------------------------

    def aggregate_classification_results(self, verbose=True):
        """Stats of every (fold, epoch), written with the patient rows and
        the maximals (reference: deepards/metrics.py:275-294)."""
        agg = []
        for fold_num in _unique(r["fold_num"] for r in self.results):
            for epoch_num in _unique(r["epoch_num"] for r in self.results):
                sub = [r for r in self.results if r["epoch_num"] == epoch_num
                       and r["fold_num"] == fold_num]
                if sub:
                    agg += aggregate_stats(sub, fold_num, epoch_num)
        if not agg:
            return None
        if verbose:
            self.print_results_report(agg)
        os.makedirs(self.results_dir, exist_ok=True)
        _write_json(self._path("patient_results"), self.results)
        _write_json(self._path("aggregate_results"), agg)
        self.save_maximals(self._path("maximal_results"), agg, verbose)
        return agg

    def _path(self, what):
        return os.path.join(self.results_dir, "{}_{}.json".format(
            self.uuid_name, what))

    def save_maximals(self, output_filename, aggregate, verbose=True):
        """Per fold, the rows of the first epoch with the maximum AUC (the
        last epoch when every AUC is NaN)
        (reference: deepards/metrics.py:296-315)."""
        maximals = []
        for fold_num in _unique(r["fold_num"] for r in aggregate):
            fold_stats = [r for r in aggregate if r["fold_num"] == fold_num]
            aucs = [r["auc"] for r in fold_stats]
            if any(not math.isnan(a) for a in aucs):
                best = fold_stats[int(np.nanargmax(aucs))]
            else:
                best = fold_stats[-1]
            maximals += [r for r in fold_stats
                         if r["epoch_num"] == best["epoch_num"]]
        _write_json(output_filename, maximals)
        if verbose:
            print("---- Max Stats ----")
            self.print_results_report(maximals)
        return maximals

    # -- predictions by hour --------------------------------------------------

    def save_predictions_by_hour(self, truth, pred_index, preds, seq_hours,
                                 epoch_num, fold_num):
        """One row per prediction with its window's first hour, patient
        and label (reference: deepards/metrics.py:633-656).  seq_hours:
        mapping absolute index -> per-subsequence hour array."""
        where = {int(i): k for k, i in enumerate(truth.index.tolist())}
        frame = []
        for idx, pred in zip(np.asarray(pred_index).tolist(),
                             np.asarray(preds).tolist()):
            k = where.get(int(idx))
            if k is None:
                continue
            hrs = np.atleast_1d(np.asarray(seq_hours[idx]))
            frame.append({"index": int(idx), "pred": pred,
                          "hour": float(hrs[0]),
                          "patient": str(truth.patient[k]),
                          "y": int(truth.y[k])})
        self.pred_to_hour_frame = frame
        self.all_pred_to_hour += [dict(r, epoch=epoch_num, fold=fold_num)
                                  for r in frame]

    # -- persistence ----------------------------------------------------------

    def save_all(self):
        """Meters (npz), hyperparameters and results (JSON)."""
        os.makedirs(self.results_dir, exist_ok=True)
        self.reporting.save_all()
        name = self.experiment_name or str(self.uuid_name)
        _write_json(os.path.join(self.results_dir, "{}_{}.json".format(
            name, self.uuid_name)), self.hyperparams)
        _write_json(
            os.path.join(self.results_dir, "{}_results_{}.json".format(
                name, self.uuid_name)),
            {
                "results": self.results,
                "all_pred_to_hour": self.all_pred_to_hour,
                "hyperparams": self.hyperparams,
                "meters": {k: list(m.values)
                           for k, m in self.reporting.meters.items()},
            })


def _json_default(value):
    if isinstance(value, np.generic):
        return value.item()
    if isinstance(value, np.ndarray):
        return value.tolist()
    return str(value)


def _write_json(path, obj):
    with open(path, "w") as f:
        json.dump(obj, f, default=_json_default)


def _print_table(rows, cols):
    print("  ".join(cols))
    for r in rows:
        print("  ".join(str(r[c]) for c in cols))
