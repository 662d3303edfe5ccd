"""Post-hoc analysis: DTW-vs-model hypotheses and prediction drill-down.

Counterpart of ``deepards_tpu/cli/analysis.py`` on numpy (no pandas):
- ``lstm-dtw``: per-patient and fold-mean DTW heterogeneity through
  ``dtw.lib.analyze_patient`` and its cache (reference:
  deepards/lstm_dtw.py:21-152), on ``--device`` (default: the card);
- ``regression_dtw_features``: DTW time-window features and a
  least-squares fit against the ARDS vote fraction (reference:
  deepards/regression_dtw.py:10-60);
- ``analyze-predictions``: a per-patient drill-down of a run's results
  JSON (reference: deepards/analyze_predictions.py);
- ``signal_distributions``: statistics of the raw and Butterworth-filtered
  window values (reference: distributions.py).
Tables are lists of row dicts under the JAX package's column names.
Run: ``python -m deepards_tpu_torch.cli.analysis {lstm-dtw,
analyze-predictions} ...``.
"""
import argparse
import math
import warnings

import numpy as np
import torch

from deepards_tpu_torch.data.pipeline import design_butter_sos, sosfilt
from deepards_tpu_torch.device import resolve_device
from deepards_tpu_torch.dtw.lib import analyze_patient, as_columns


def _nanmean(values):
    """Mean over the values that are not NaN, NaN if none (pandas'
    ``mean``)."""
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", RuntimeWarning)
        return float(np.nanmean(values))


def _std(values):
    """Sample standard deviation, NaN under two values (pandas' ``std``)."""
    values = np.asarray(values, np.float64)
    return float(np.std(values, ddof=1)) if len(values) > 1 else math.nan


def lstm_dtw_analysis(dataset, cache_dir="dtw_cache", device=None):
    """Mean DTW heterogeneity per patient and over the fold
    (reference: lstm_dtw.py:21-152)."""
    gt = dataset.get_ground_truth()
    per_pt = {}
    for pt in gt.patients():
        frame = analyze_patient(pt, dataset, cache_dir, None, device=device)
        per_pt[pt] = _nanmean(frame.dtw)
    return {"per_patient_mean_dtw": per_pt,
            "fold_mean_dtw": _nanmean(list(per_pt.values()))}


def regression_dtw_features(dataset, preds_by_hour, cache_dir="dtw_cache",
                            window_hours=1.0, device=None):
    """Hourly-window DTW features regressed against the ARDS vote fraction
    (reference: regression_dtw.py:10-60, which used logit/OLS).

    ``preds_by_hour``: prediction rows with ``index``, ``pred``, ``hour``
    and ``patient`` (``DeepARDSResults.pred_to_hour_frame``).  Returns
    (feature rows, fit or None under 3 rows)."""
    rows, columns = [], as_columns(preds_by_hour)
    for pt in dict.fromkeys(r["patient"] for r in preds_by_hour):
        frame = analyze_patient(pt, dataset, cache_dir, columns,
                                device=device)
        keep = ~(np.isnan(frame.dtw) | np.isnan(frame.hour))
        dtw, hour = frame.dtw[keep], frame.hour[keep]
        pt_preds = [r for r in preds_by_hour if r["patient"] == pt]
        p_hour = np.asarray([r["hour"] for r in pt_preds], np.float64)
        p_pred = np.asarray([r["pred"] for r in pt_preds], np.float64)
        for h0 in np.arange(0, 24, window_hours):
            sel = dtw[(hour >= h0) & (hour < h0 + window_hours)]
            psel = p_pred[(p_hour >= h0) & (p_hour < h0 + window_hours)]
            if not len(sel) or not len(psel):
                continue
            rows.append({"patient": pt, "hour": float(h0),
                         "mean_dtw": float(sel.mean()),
                         "std_dtw": _std(sel),
                         "pred_frac": float(psel.mean())})
    if len(rows) < 3:
        return rows, None
    x = np.stack([np.ones(len(rows)), [r["mean_dtw"] for r in rows]], 1)
    y = np.asarray([r["pred_frac"] for r in rows])
    coef, *_ = np.linalg.lstsq(x, y, rcond=None)
    resid = y - x @ coef
    ss_tot = ((y - y.mean()) ** 2).sum()
    r2 = 1 - (resid ** 2).sum() / ss_tot if ss_tot else 0.0
    return rows, {"intercept": float(coef[0]), "slope": float(coef[1]),
                  "r2": float(r2)}


def analyze_predictions(patient_results_path):
    """Per-patient drill-down of a run's patient rows, by ascending mean
    ARDS vote fraction (reference: analyze_predictions.py)."""
    from deepards_tpu_torch.cli.sim_dissim import read_patient_results

    results = read_patient_results(patient_results_path)
    out = []
    for pt in sorted(set(r["patient"] for r in results)):
        rows = [r for r in results if r["patient"] == pt]
        frac = [r["pred_frac"] for r in rows]
        out.append({
            "patient": pt,
            "patho": int(rows[0]["patho"]),
            "mean_pred_frac": float(np.mean(frac)),
            "vote_stability": _std(frac),
            "n_epochs_wrong": sum(r["patho"] != r["prediction"]
                                  for r in rows),
            "n_rows": len(rows),
        })
    # pandas' sort_values: an unstable quicksort, NaN last
    means = np.asarray([r["mean_pred_frac"] for r in out])
    finite = np.flatnonzero(~np.isnan(means))
    order = list(finite[np.argsort(means[finite], kind="quicksort")])
    order += list(np.flatnonzero(np.isnan(means)))
    return [out[i] for i in order]


def signal_distributions(dataset, butter_configs=((None, None), (0, 10.0)),
                         device=None):
    """Mean, std and 1st/99th percentiles of the cache's values, raw and
    through each (low, high) Butterworth filter, the filter on ``device``
    (default: the card) (reference: distributions.py)."""
    data = dataset.cache.data
    stats = {}
    for low, high in butter_configs:
        sos = design_butter_sos(low, high)
        if sos is None:
            vals = data
            name = "raw"
        else:
            x = torch.as_tensor(data, device=resolve_device(device))
            vals = sosfilt(sos, x).cpu().numpy()
            name = "butter_{}_{}".format(low, high)
        stats[name] = {
            "mean": float(vals.mean()),
            "std": float(vals.std()),
            "p01": float(np.percentile(vals, 1)),
            "p99": float(np.percentile(vals, 99)),
        }
    return stats


def main(argv=None):
    parser = argparse.ArgumentParser(prog="deepards-analysis-torch")
    sub = parser.add_subparsers(dest="cmd", required=True)

    p = sub.add_parser("analyze-predictions")
    p.add_argument("patient_results",
                   help="a run's *_results_*.json or *_patient_results.json")

    p = sub.add_parser("lstm-dtw")
    p.add_argument("--train-from-pickle", required=True,
                   help="a saved .npz dataset")
    p.add_argument("--fold", type=int, default=0)
    p.add_argument("--cache-dir", default="dtw_cache")
    p.add_argument("--device",
                   help="torch device of the DTW (default: cuda; raises "
                   "when no card is present)")

    args = parser.parse_args(argv)
    if args.cmd == "analyze-predictions":
        from deepards_tpu_torch.eval.metrics import _print_table

        table = analyze_predictions(args.patient_results)
        _print_table(table, ["patient", "patho", "mean_pred_frac",
                             "vote_stability", "n_epochs_wrong", "n_rows"])
        return table
    from deepards_tpu_torch.data.dataset import ARDSRawDataset

    ds = ARDSRawDataset.from_pickle(args.train_from_pickle)
    if ds.total_kfolds:  # a holdout dataset has no folds to choose
        ds.set_kfold_indexes_for_fold(args.fold)
    res = lstm_dtw_analysis(ds, args.cache_dir, device=args.device)
    print("fold mean DTW: {:.2f}".format(res["fold_mean_dtw"]))
    for pt, v in res["per_patient_mean_dtw"].items():
        print("  {}: {:.2f}".format(pt, v))
    return res


if __name__ == "__main__":
    main()
