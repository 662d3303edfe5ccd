"""Patient-level metrics across runs, at each fold's best epoch.

Counterpart of ``deepards_tpu/cli/mean_metrics.py`` (reference:
deepards/mean_metrics.py:19-120):

  python -m deepards_tpu_torch.cli.mean_metrics [--results-dir results]
      [files ...] [--plot]

It reads the patient rows (fold_num, epoch_num, patho, prediction,
pred_frac) of the port's ``{name}_results_{uuid}.json`` files and of the
JAX package's and the reference's ``*_patient_results.pkl`` frames
(through ``data.legacy_pickle``, no pandas; a frame of the legacy
columns is lifted by ``eval.legacy_results.legacy_to_new_store``): by
default the JSON files in --results-dir, or its frames where it holds no
JSON (a JAX or a reference run's directory).  It recomputes each fold's
and epoch's confusion counts, AUC, accuracy, sensitivity, specificity,
precision and F1 in numpy (``eval.metrics.roc_auc``; no scikit-learn),
takes the mean over runs and reports each fold's epoch of the highest
mean AUC.  The tables are columns: a dict of numpy arrays under the JAX
frames' column names.  ``--plot`` draws the AUC by epoch with
matplotlib, on the CPU host.
"""
import argparse
import glob
import json
import os

import numpy as np

from deepards_tpu_torch.data import legacy_pickle
from deepards_tpu_torch.eval.legacy_results import legacy_to_new_store
from deepards_tpu_torch.eval.metrics import roc_auc

METRIC_COLUMNS = ["AUC", "Accuracy", "sensitivity", "specificity",
                  "precision", "f1"]


def load_results(path):
    """The patient rows of a results JSON or a ``*_patient_results.pkl``
    frame."""
    if path.endswith(".pkl"):
        frame = legacy_pickle.load_frame(path)
        if "patient_id" in frame:
            return legacy_to_new_store(frame.rows())
        return frame.rows()
    with open(path) as f:
        return json.load(f)["results"]


def compute_metrics_from_patient_results(rows):
    """Per fold and epoch (in order of first appearance), the stats of
    its patient rows, as columns fold, epoch and ``METRIC_COLUMNS``
    (reference: mean_metrics.py:19-55)."""
    fold = np.asarray([r["fold_num"] for r in rows])
    epoch = np.asarray([r["epoch_num"] for r in rows])
    patho = np.asarray([r["patho"] for r in rows])
    pred = np.asarray([r["prediction"] for r in rows])
    frac = np.asarray([r["pred_frac"] for r in rows], np.float64)
    out = []
    for f in dict.fromkeys(fold.tolist()):
        for e in dict.fromkeys(epoch.tolist()):
            sel = (fold == f) & (epoch == e)
            if not sel.any():
                continue
            y, p = patho[sel], pred[sel]
            tp = float(((y == 1) & (p == 1)).sum())
            tn = float(((y == 0) & (p == 0)).sum())
            fp = float(((y == 0) & (p == 1)).sum())
            fn = float(((y == 1) & (p == 0)).sum())
            total = tp + tn + fp + fn
            accuracy = round((tp + tn) / total, 4) if total else 0
            sensitivity = round(tp / (tp + fn), 4) if tp + fn else 0
            specificity = round(tn / (tn + fp), 4) if tn + fp else 0
            precision = round(tp / (tp + fp), 4) if tp + fp else 0
            f1 = (round(2 * precision * sensitivity
                        / (precision + sensitivity), 4)
                  if precision + sensitivity else 0)
            out.append(dict(zip(["fold", "epoch"] + METRIC_COLUMNS, [
                f, e, roc_auc(y, frac[sel]), accuracy, sensitivity,
                specificity, precision, f1])))
    return {k: np.asarray([r[k] for r in out], np.float64)
            for k in ["fold", "epoch"] + METRIC_COLUMNS}


def sort_descending(values):
    """The order of pandas' ``sort_values(ascending=False)`` (its default
    quicksort, NaNs last): the values reversed, argsorted, the order
    reversed, so tied values keep the order quicksort gives them."""
    values = np.asarray(values, np.float64)
    nan = np.isnan(values)
    idx = np.arange(len(values))[~nan][::-1]
    order = idx[values[~nan][::-1].argsort(kind="quicksort")][::-1]
    return np.concatenate([order, np.flatnonzero(nan)])


def get_metrics(results_files):
    """(mean stats at each fold's highest-AUC epoch, the stats of every
    run): the runs' stats averaged by (fold, epoch), rounded to 4
    places; per fold, the first row of the mean AUC in descending order
    (pandas' ``sort_values`` then ``drop_duplicates``), folds ascending,
    ``epoch`` named ``max_epoch`` (reference: mean_metrics.py:62-78)."""
    runs = [compute_metrics_from_patient_results(load_results(p))
            for p in results_files]
    stats = {k: np.concatenate([r[k] for r in runs]) for k in runs[0]}
    keys = sorted(set(zip(stats["fold"].tolist(), stats["epoch"].tolist())))
    means = {k: [] for k in stats}
    for f, e in keys:
        sel = (stats["fold"] == f) & (stats["epoch"] == e)
        means["fold"].append(f)
        means["epoch"].append(e)
        for col in METRIC_COLUMNS:
            vals = stats[col][sel]
            vals = vals[~np.isnan(vals)]
            means[col].append(vals.mean() if len(vals) else np.nan)
    means = {k: np.round(np.asarray(v, np.float64), 4)
             for k, v in means.items()}
    order = sort_descending(means["AUC"])
    _, first = np.unique(means["fold"][order], return_index=True)
    best = order[np.sort(first)]
    best = best[np.argsort(means["fold"][best], kind="stable")]
    mean_stats = {("max_epoch" if k == "epoch" else k): v[best]
                  for k, v in means.items()}
    mean_stats["fold"] = mean_stats["fold"].astype(int)
    mean_stats["max_epoch"] = mean_stats["max_epoch"].astype(int)
    return mean_stats, stats


def plot_auc(stats, out):
    """Mean AUC by epoch, one line a fold, as a PNG (matplotlib)."""
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    for fold in np.unique(stats["fold"]):
        sel = stats["fold"] == fold
        epochs = np.unique(stats["epoch"][sel])
        plt.plot(epochs, [np.nanmean(stats["AUC"][sel & (stats["epoch"]
                                                         == e)])
                          for e in epochs], label="fold {}".format(int(fold)))
    plt.xlabel("epoch")
    plt.ylabel("AUC")
    plt.legend()
    plt.savefig(out, dpi=120)
    return out


def main(argv=None):
    parser = argparse.ArgumentParser(prog="deepards-mean-metrics-torch")
    parser.add_argument("--results-dir", default="results")
    parser.add_argument("files", nargs="*",
                        help="*_results_*.json and *_patient_results.pkl "
                        "files (default: the JSON files in --results-dir, "
                        "else its .pkl frames)")
    parser.add_argument("--plot", action="store_true")
    args = parser.parse_args(argv)
    # the port's runs write JSON; a directory without any is a JAX or a
    # reference run's, read through its frames
    files = args.files or sorted(
        glob.glob(os.path.join(args.results_dir, "*_results_*.json"))
        or glob.glob(os.path.join(args.results_dir,
                                  "*_patient_results.pkl")))
    if not files:
        raise SystemExit("no *_results_*.json or *_patient_results.pkl "
                         "files found")
    mean_stats, stats = get_metrics(files)
    print("Mean stats at max-AUC epoch per fold ({} runs):".format(
        len(files)))
    cols = list(mean_stats)
    print("  ".join(cols))
    for row in zip(*(mean_stats[c].tolist() for c in cols)):
        print("  ".join(str(v) for v in row))
    if args.plot:
        print("plot saved to", plot_auc(stats, os.path.join(
            args.results_dir, "mean_metrics_auc.png")))
    return mean_stats


if __name__ == "__main__":
    main()
