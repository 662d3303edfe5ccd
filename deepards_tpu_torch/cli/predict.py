"""Inference CLI: run a trained checkpoint over a cohort's windows.

Counterpart of ``deepards_tpu/cli/predict.py``.  It builds the run's
datasets as the trainer does, restores the checkpoint into the fold's
state (the params and, when the checkpoint has it, the dropout
generator), and runs the trainer's eval step over the fold's test windows
in order, in batches of ``batch_size`` whose last is zero-padded with row
mask 0, so ``bn_row_mask`` keeps the pad rows out of the normalization
statistics.  It writes the per-window probabilities as CSV (window_index,
patient, hour, prob_other, prob_ards, prediction) and the patient votes
as JSON records (patient, pred_frac, n_windows, prediction, where
pred_frac >= 0.5 votes ARDS), the JAX package's columns and fields, with
``csv`` and ``json``.

A per-breath head's (cnn_lstm) window probabilities are the mean of its
S windows' softmax, as in the JAX package.  A regressor is refused: the
rows are class probabilities.

The dropout masks come from the checkpoint's generator, so the
probabilities are those of the trainer's eval of the same checkpoint
(``cli.train --load-checkpoint <it> --no-train``).  The batch transforms
are the training fold's, as in that eval: mu = 0 under augmentation,
where the JAX package's predict normalizes with the test view's pipeline,
which keeps mu.

Run: ``python -m deepards_tpu_torch.cli.predict --checkpoint model.pt
-co exp.yml --data-path <cohort dir> [--device cpu]`` (the training
flags, ``--device`` defaulting to the card).
"""
import argparse
import csv
import json

import torch

from deepards_tpu_torch.data.pipeline import BatchPipeline
from deepards_tpu_torch.train.loop import make_trainer
from deepards_tpu_torch.train.steps import make_train_step

WINDOW_COLUMNS = ["window_index", "patient", "hour", "prob_other",
                  "prob_ards", "prediction"]


def predict(conf, checkpoint_path, batch_size=16, device=None):
    """(rows, votes): one dict per test window of ``WINDOW_COLUMNS``, and
    one per patient (sorted by patient) with its vote."""
    trainer = make_trainer(conf, device=device, verbose=False)
    if trainer.spec.kind != "classifier":
        raise ValueError("{} is a {}: predict writes class "
                         "probabilities".format(conf.network,
                                                trainer.spec.kind))
    train_ds, test_ds = trainer.get_base_datasets()
    fold = conf.get("only_fold") or 0
    if conf.get("kfolds"):
        train_ds.set_kfold_indexes_for_fold(fold)
        test_ds.set_kfold_indexes_for_fold(fold)
    state = trainer.restore_state(trainer.new_state(fold), checkpoint_path)
    _, eval_step = make_train_step(
        trainer.loss_fn, transform=BatchPipeline(train_ds, trainer.device),
        compute_dtype=trainer.compute_dtype,
        eval_dropout_active=not trainer.spec.eval_dropout_off,
        target_mode=trainer.spec.target_mode)
    idxs = test_ds.current_indices()
    truth = test_ds.get_ground_truth()  # in the order of idxs
    rows = []
    for start in range(0, len(idxs), batch_size):
        chunk = idxs[start:start + batch_size]
        batch = trainer.device_batch(test_ds.gather(chunk), batch_size)
        _, logits = eval_step(state, **batch)
        probs = torch.softmax(logits, dim=-1)[:len(chunk)]
        if probs.ndim == 3:  # a per-breath head: the mean of its windows
            probs = probs.mean(dim=1)
        probs = probs.cpu().numpy()
        for i, widx in enumerate(chunk):
            rows.append({
                "window_index": int(widx),
                "patient": str(truth.patient[start + i]),
                "hour": float(truth.hour[start + i]),
                "prob_other": float(probs[i, 0]),
                "prob_ards": float(probs[i, 1]),
                "prediction": int(probs[i].argmax()),
            })
    return rows, patient_votes(rows)


def patient_votes(rows):
    """Per patient, sorted: the fraction of windows predicted ARDS, their
    count, and the vote (ARDS when the fraction is >= 0.5)."""
    by_patient = {}
    for row in rows:
        by_patient.setdefault(row["patient"], []).append(row["prediction"])
    votes = []
    for patient in sorted(by_patient):
        preds = by_patient[patient]
        frac = sum(preds) / len(preds)
        votes.append({"patient": patient, "pred_frac": frac,
                      "n_windows": len(preds),
                      "prediction": int(frac >= 0.5)})
    return votes


def main(argv=None):
    from deepards_tpu_torch.cli.train import build_parser
    from deepards_tpu_torch.config.config import Configuration

    parser = argparse.ArgumentParser(prog="deepards-predict-torch",
                                     add_help=False)
    parser.add_argument("--checkpoint", required=True)
    parser.add_argument("-o", "--output", default="predictions.csv")
    parser.add_argument("--votes-output", default="patient_votes.json")
    args, rest = parser.parse_known_args(argv)

    conf = Configuration(build_parser().parse_args(rest))
    rows, votes = predict(conf, args.checkpoint, conf.get("batch_size", 16))
    with open(args.output, "w", newline="") as f:
        writer = csv.DictWriter(f, fieldnames=WINDOW_COLUMNS)
        writer.writeheader()
        writer.writerows(rows)
    with open(args.votes_output, "w") as f:
        json.dump(votes, f, indent=2)
    for vote in votes:
        print("{patient} pred_frac={pred_frac:.4f} n_windows={n_windows} "
              "prediction={prediction}".format(**vote))
    print("window predictions -> {}".format(args.output))
    print("patient votes -> {}".format(args.votes_output))
    return rows, votes


if __name__ == "__main__":
    main()
