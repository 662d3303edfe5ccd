"""Readers for the reference's legacy result artifacts, without pandas.

Counterpart of ``deepards_tpu/eval/legacy_results.py`` (reference:
deepards/results.py: ModelCollection/ModelResults/PatientResults, and the
``{time}_patient_results.pkl`` DataFrame pickles its mean_metrics.py
consumes at :64/:148/:218), over the port's row dicts instead of frames:

1. ``model_collection_results_*.pkl``, a pickled ModelCollection object
   (results.py:433-440), is read through ``data.legacy_pickle`` (stubs for
   the reference package) and flattened to legacy patient rows.
2. ``{start_time}_patient_results.pkl``, a DataFrame with the legacy
   columns ``LEGACY_COLUMNS`` or the new store's (``eval/metrics.py``), is
   read through ``data.legacy_pickle``'s frame stubs.

Both convert into the new store's rows, and the legacy aggregate
statistics (count_predictions + calc_results, results.py:113-243) are
re-derived in numpy (the AUC by ``eval.metrics.roc_auc``, no
scikit-learn).
"""
import numpy as np

from deepards_tpu_torch.data import legacy_pickle
from deepards_tpu_torch.eval.metrics import roc_auc

LEGACY_COLUMNS = [
    "patient_id", "other_votes", "ards_votes", "frac_votes",
    "majority_prediction", "fold_idx", "model_idx", "ground_truth",
]
AGGREGATE_COLUMNS = [
    "patho", "acc", "recall", "spec", "prec", "npv", "auc",
    "acc_ci", "recall_ci", "spec_ci", "prec_ci", "npv_ci", "auc_ci",
]


def load_model_collection(path):
    """A pickled reference ModelCollection's legacy patient rows
    (reference: results.py:151-183)."""
    obj = legacy_pickle.load(path)
    rows = []
    for model in obj.__dict__.get("models", []):
        for pr in model.__dict__.get("all_patient_results", []):
            p = pr.__dict__
            total = p["other_votes"] + p["ards_votes"]
            rows.append(dict(zip(LEGACY_COLUMNS, [
                p["patient_id"], p["other_votes"], p["ards_votes"],
                p["ards_votes"] / float(total) if total else np.nan,
                p["majority_prediction"], p["fold_idx"], p["model_idx"],
                p["ground_truth"]])))
    return rows


def load_legacy_patient_results(path):
    """A ``{time}_patient_results.pkl`` frame's legacy rows; a frame of
    the new store's schema is projected onto the legacy columns."""
    frame = legacy_pickle.load_frame(path)
    if "patient_id" in frame:
        return frame.rows([c for c in LEGACY_COLUMNS if c in frame])
    return new_store_to_legacy(frame.rows())


def _votes(row, patho):
    """A row's votes for ``patho``: ``legacy_to_new_store``'s column, or
    the results store's (``OTHER_votes``, ``ARDS_votes``), which the JAX
    package's ``new_store_to_legacy`` does not read (it raises KeyError on
    the frames its own store writes)."""
    key = "{}_votes".format(patho)
    return row[key] if key in row else row[patho.upper() + "_votes"]


def new_store_to_legacy(rows):
    """The new store's per-(patient, epoch, fold) rows on the legacy
    columns; ``model_idx`` is the epoch, 0.0 where the rows have none."""
    return [dict(zip(LEGACY_COLUMNS, [
        r["patient"], _votes(r, "other"), _votes(r, "ards"), r["pred_frac"],
        r["prediction"], r["fold_num"], r.get("epoch_num", 0.0),
        r["patho"]])) for r in rows]


def legacy_to_new_store(rows):
    """Legacy rows in the new store's schema, so ``cli.mean_metrics`` and
    the visualize tooling read old runs unchanged."""
    out = []
    for r in rows:
        gt = int(r["ground_truth"])
        pred = int(r["majority_prediction"])
        row = {"patient": r["patient_id"], "patho": gt,
               "other_votes": r["other_votes"],
               "ards_votes": r["ards_votes"], "prediction": pred,
               "pred_frac": r["frac_votes"],
               "epoch_num": int(r["model_idx"]),
               "fold_num": int(r["fold_idx"])}
        for patho_int, patho in ((0, "other"), (1, "ards")):
            hit, truth = pred == patho_int, gt == patho_int
            row["{}_tps".format(patho)] = int(hit and truth)
            row["{}_fps".format(patho)] = int(hit and not truth)
            row["{}_tns".format(patho)] = int(not hit and not truth)
            row["{}_fns".format(patho)] = int(not hit and truth)
        out.append(row)
    return out


def _column(rows, name, dtype=np.float64):
    return np.asarray([r[name] for r in rows], dtype)


def count_predictions(patient_results, threshold):
    """Per-patho tp/tn/fp/fn counts at a vote-fraction threshold, with
    the legacy orientation: 'other' below the threshold, 'ards' at or
    above it (reference: results.py:113-149)."""
    frac = _column(patient_results, "frac_votes")
    truth = _column(patient_results, "ground_truth")
    counts = {}
    for patho_int, patho in ((0, "other"), (1, "ards")):
        eq = frac < threshold if patho_int == 0 else frac >= threshold
        gt_eq = truth == patho_int
        counts["{}_tps_{}".format(patho, threshold)] = int((eq & gt_eq).sum())
        counts["{}_tns_{}".format(patho, threshold)] = int(
            (~eq & ~gt_eq).sum())
        counts["{}_fps_{}".format(patho, threshold)] = int(
            (eq & ~gt_eq).sum())
        counts["{}_fns_{}".format(patho, threshold)] = int(
            (~eq & gt_eq).sum())
    return counts


def _nunique(values):
    """Distinct values, NaN not counted (a frame's ``nunique``)."""
    return len({v for v in values if v == v})


def _ratio(num, den):
    """num / den elementwise, NaN where both are 0 (pandas' division of
    int columns)."""
    num = np.asarray(num, np.float64)
    den = np.asarray(den, np.float64)
    with np.errstate(divide="ignore", invalid="ignore"):
        return num / den


def calc_aggregate_stats(patient_results, threshold=0.5):
    """The legacy aggregate results, one row a patho of
    ``AGGREGATE_COLUMNS``: acc/recall/spec/prec/npv averaged over the
    models (``model_idx``, ascending) with binomial CIs, and the mean AUC
    of the models that saw both classes (reference: results.py:204-243)."""
    if threshold > 1:
        threshold = threshold / 100.0
    models = sorted({r["model_idx"] for r in patient_results
                     if r["model_idx"] == r["model_idx"]})
    by_model = [[r for r in patient_results if r["model_idx"] == m]
                for m in models]
    counts = [count_predictions(pts, threshold) for pts in by_model]
    aucs = []
    for pts in by_model:
        if _nunique(r["ground_truth"] for r in pts) < 2:
            continue
        frac = _column(pts, "frac_votes")
        if np.isnan(frac).any():
            # scikit-learn's roc_curve refuses NaN, and the JAX run fails
            raise ValueError("frac_votes of model {} hold NaN (a patient "
                             "without votes)".format(pts[0]["model_idx"]))
        aucs.append(roc_auc(_column(pts, "ground_truth"), frac))
    uniq_pts = _nunique(r["patient_id"] for r in patient_results)
    mean_auc = round(float(np.mean(aucs)), 3) if aucs else np.nan
    auc_ci = (round(float(1.96 * np.sqrt(mean_auc * (1 - mean_auc)
                                         / uniq_pts)), 3)
              if aucs else np.nan)

    out = []
    for patho in ("other", "ards"):
        tps, tns, fps, fns = (
            np.asarray([c["{}_{}_{}".format(patho, kind, threshold)]
                        for c in counts], np.int64)
            for kind in ("tps", "tns", "fps", "fns"))
        stats = np.stack([
            _ratio(tns + tps, tns + tps + fns + fps),
            _ratio(tps, tps + fns),
            _ratio(tns, tns + fps),
            _ratio(tps, fps + tps),
            _ratio(tns, tns + fns),
        ], axis=1)
        with np.errstate(invalid="ignore"):
            means = np.round(np.array([
                np.nanmean(col) if (~np.isnan(col)).any() else np.nan
                for col in stats.T]), 3)
            cis = np.round(1.96 * np.sqrt(means * (1 - means) / uniq_pts), 3)
        out.append(dict(zip(AGGREGATE_COLUMNS, [
            patho, *means.tolist(),
            round(mean_auc, 2) if aucs else np.nan,
            *cis.tolist(), auc_ci])))
    return out
