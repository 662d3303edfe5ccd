"""DL against a random-forest baseline (the aim2 paper figures).

Counterpart of ``deepards_tpu/cli/dl_vs_rf.py`` (reference:
deepards/aim2_dl_v_rf_compr/: fractional_patient_training.py:13-46,
plot_roc_curves.py, dl_rf_pt_diffs.py), over row dicts instead of
frames.  The forest is scikit-learn's ``RandomForestClassifier``, fitted
on the CPU host only (the card's machine has no scikit-learn: there it is
refused by name) on per-window mean flow-time features
(``data/breath.py``), its windows voted per patient as the DL path votes;
the AUCs and ROC curves are the port's own (``eval/metrics.py``).  The
fractional DL curve trains through the port's trainer on its device.

  python -m deepards_tpu_torch.cli.dl_vs_rf rf --train-from-pickle ds.npz
  python -m deepards_tpu_torch.cli.dl_vs_rf pt-diffs rf.pkl dl1.pkl ...

``pt-diffs`` reads patient-result frames pickled by pandas (the JAX
package's ``*_patient_results.pkl``) or the port's ``.json`` rows.
"""
import argparse
import json
import os
from collections import Counter

import numpy as np

from deepards_tpu_torch.data.breath import flow_time_features
from deepards_tpu_torch.eval.metrics import roc_auc, roc_curve
from deepards_tpu_torch.utils import figures


def window_bm_features(dataset, indices):
    """Each window's mean flow-time features over its breaths with all 9
    defined (zeros where none is)."""
    feats = []
    for i in indices:
        window = dataset.cache.data[int(i)]  # (S, C, L)
        rows = np.asarray([
            flow_time_features(w[0][w[0] != 0] if (w[0] != 0).any()
                               else w[0])
            for w in window], np.float64)
        rows = rows[~np.any(np.isnan(rows) | np.isinf(rows), axis=1)]
        feats.append(rows.mean(axis=0) if len(rows) else np.zeros(9))
    return np.asarray(feats)


def _forest(n_estimators, seed):
    try:
        from sklearn.ensemble import RandomForestClassifier
    except ImportError:
        raise ImportError(
            "the random forest is scikit-learn's RandomForestClassifier, "
            "fitted on the CPU host, and scikit-learn is missing") from None
    return RandomForestClassifier(n_estimators=n_estimators,
                                  random_state=seed)


def rf_patient_metrics(dataset, fold_num, n_estimators=100, seed=0):
    """A forest on the fold's train windows, its test windows voted per
    patient: {auc, accuracy, rows (one a patient, sorted), model,
    importances}."""
    train_idx = dataset.get_kfold_indexes_for_fold(fold_num, train=True)
    test_idx = dataset.get_kfold_indexes_for_fold(fold_num, train=False)
    x_train = window_bm_features(dataset, train_idx)
    y_train = dataset.cache.target[train_idx].argmax(axis=1)
    x_test = window_bm_features(dataset, test_idx)
    y_test = dataset.cache.target[test_idx].argmax(axis=1)
    rf = _forest(n_estimators, seed)
    rf.fit(np.nan_to_num(x_train), y_train)
    preds = (rf.predict_proba(np.nan_to_num(x_test))[:, 1] >= 0.5).astype(
        int)
    pts = np.array([dataset.cache.patients[dataset.cache.patient_idx[int(i)]]
                    for i in test_idx])
    rows = []
    for pt in np.unique(pts):
        m = pts == pt
        frac = preds[m].mean()
        rows.append({"patient": str(pt), "patho": int(y_test[m][0]),
                     "pred_frac": float(frac),
                     "prediction": int(frac >= 0.5)})
    patho = np.asarray([r["patho"] for r in rows])
    return {
        "auc": roc_auc(patho, [r["pred_frac"] for r in rows]),
        "accuracy": float((patho == np.asarray(
            [r["prediction"] for r in rows])).mean()),
        "rows": rows, "model": rf,
        "importances": dict(zip(range(9), rf.feature_importances_)),
    }


def fractional_training_curve(conf_builder, fractions=(0.025, 0.05, 0.1,
                                                       0.25, 0.5, 1.0),
                              device=None):
    """The DL runs' mean last-epoch AUC and accuracy over the folds as the
    training-patient fraction grows (reference:
    fractional_patient_training.py:13-46); ``conf_builder(frac)`` gives
    the configuration.  One row a fraction."""
    from deepards_tpu_torch.train.loop import make_trainer

    rows = []
    for frac in fractions:
        trainer = make_trainer(conf_builder(frac), device=device,
                               verbose=False)
        results = trainer.train_and_test()
        last = {name: [results.get_meter(name, f).values[-1]
                       for f in range(trainer.n_kfolds)
                       if len(results.get_meter(name, f).values)]
                for name in ("test_auc", "test_patient_accuracy")}
        rows.append({"train_pt_frac": frac, **{
            key: float(np.nanmean(last[name])) if last[name] else np.nan
            for key, name in (("auc", "test_auc"),
                              ("accuracy", "test_patient_accuracy"))}})
    return rows


def _wrong(rows):
    """(each patient's fraction of wrong rows, its count of them)."""
    trials = Counter(r["patient"] for r in rows)
    wrong = Counter(r["patient"] for r in rows
                    if r["patho"] != r["prediction"])
    return ({pt: wrong[pt] / n for pt, n in trials.items()},
            {pt: wrong[pt] for pt in trials})


def pt_diffs(dl_runs, rf_rows):
    """The patients the DL runs fix that the forest misclassifies
    (reference: dl_rf_pt_diffs.py:10-38, as the JAX package states it):
    improved where the forest is wrong in a majority of its rows and the
    DL runs' last epochs in a minority of theirs; regressed the other way.
    ``dl_runs``: each run's patient rows; ``rf_rows``: the forest's."""
    dl = []
    for i, rows in enumerate(dl_runs):
        last = max(r["epoch_num"] for r in rows)
        dl += [dict(r, model_num=i) for r in rows if r["epoch_num"] == last]
    dl_frac, dl_wrong = _wrong(dl)
    rf_frac, _ = _wrong(rf_rows)
    both = set(dl_frac) & set(rf_frac)
    improved = sorted(pt for pt in both
                      if rf_frac[pt] >= 0.5 and dl_frac[pt] < 0.5)
    return {
        "dl_mispreds": {pt: n for pt, n in dl_wrong.items() if n > 0},
        "rf_mispreds": dict(Counter(r["patient"] for r in rf_rows
                                    if r["patho"] != r["prediction"])),
        "common_mispreds": sorted(
            {pt for pt, n in dl_wrong.items() if n > 0}
            & {pt for pt, f in rf_frac.items() if f > 0}),
        "improved_pts": improved,
        "regressed_pts": sorted(pt for pt in both if dl_frac[pt] >= 0.5
                                and rf_frac[pt] < 0.5),
        "improved_detail": {pt: next(r for r in dl if r["patient"] == pt)
                            for pt in improved},
    }


def roc_curves(dl_rows, rf_rows):
    """{DL, RF: (fpr, tpr, auc)} of the patient rows' pred_frac."""
    out = {}
    for name, rows in (("DL", dl_rows), ("RF", rf_rows)):
        if rows:
            patho = [r["patho"] for r in rows]
            frac = [r["pred_frac"] for r in rows]
            out[name] = roc_curve(patho, frac)[:2] + (roc_auc(patho, frac),)
    return out


def _draw_roc(path, curves):
    plt = figures.pyplot()
    fig, ax = plt.subplots(figsize=(5, 5))
    for name, (fpr, tpr, auc) in curves.items():
        ax.plot(fpr, tpr, label="{} (AUC {:.3f})".format(name, auc))
    ax.plot([0, 1], [0, 1], "k--", lw=0.5)
    ax.set_xlabel("false positive rate")
    ax.set_ylabel("true positive rate")
    ax.legend()
    fig.savefig(path, dpi=120, bbox_inches="tight")
    plt.close(fig)
    return path


def plot_roc_curves(dl_rows, rf_rows, out_path="roc-dl-ml.png",
                    device="cpu"):
    """Both models' patient ROC curves (reference: plot_roc_curves.py):
    an ``.npz`` of ``roc_curves`` beside ``out_path`` and, on the CPU host
    with matplotlib, the PNG.  Returns ``out_path``."""
    curves = roc_curves(dl_rows, rf_rows)
    np.savez(os.path.splitext(out_path)[0] + ".npz", **{
        "{}_{}".format(name, key): value
        for name, curve in curves.items()
        for key, value in zip(("fpr", "tpr", "auc"), curve)})
    figures.draw_or_refuse([(out_path, lambda path: _draw_roc(
        path, curves))], device)
    return out_path


def load_patient_rows(path):
    """Patient rows of a pickled results frame (no pandas) or of the
    port's ``.json`` rows."""
    if path.endswith(".json"):
        with open(path) as f:
            return json.load(f)
    from deepards_tpu_torch.data import legacy_pickle

    return legacy_pickle.load_frame(path).rows()


def main(argv=None):
    parser = argparse.ArgumentParser(prog="deepards-dl-vs-rf-torch")
    sub = parser.add_subparsers(dest="command", required=True)
    rf = sub.add_parser("rf", help="train and vote a flow-time RF baseline")
    rf.add_argument("--train-from-pickle", required=True)
    rf.add_argument("--fold", type=int, default=0)
    rf.add_argument("--n-estimators", type=int, default=100)
    diffs = sub.add_parser("pt-diffs",
                           help="patients the DL runs fix against the RF")
    diffs.add_argument("rf_results", help="the RF's patient rows")
    diffs.add_argument("dl_results", nargs="+",
                       help="patient rows, one file per DL run")
    args = parser.parse_args(argv)

    if args.command == "pt-diffs":
        out = pt_diffs([load_patient_rows(p) for p in args.dl_results],
                       load_patient_rows(args.rf_results))
        print("DL improves on {} patients the RF misclassifies:".format(
            len(out["improved_pts"])))
        for pt in out["improved_pts"]:
            row = out["improved_detail"][pt]
            print("  ", pt, *(row[c] for c in ("patho", "prediction",
                                               "pred_frac") if c in row))
        return out

    from deepards_tpu_torch.data.dataset import ARDSRawDataset

    ds = ARDSRawDataset.from_pickle(args.train_from_pickle)
    out = rf_patient_metrics(ds, args.fold, args.n_estimators)
    print("RF fold {}: AUC={:.4f} accuracy={:.4f}".format(
        args.fold, out["auc"], out["accuracy"]))
    for row in out["rows"]:
        print("  ", row["patient"], row["patho"], row["pred_frac"],
              row["prediction"])
    return out


if __name__ == "__main__":
    main()
