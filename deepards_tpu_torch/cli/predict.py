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
S windows' softmax, as in the JAX package.  A 2D network's rows are its
test images (``deepards_tpu/cli/predict.py:28-45``): no batch pipeline,
since ``gather`` normalizes, and the row mask over the images.  A nested network is
predicted as its trainer evaluates it: one patient's windows a super
batch (the JAX predict feeds it chunks of ``batch_size`` windows, each
read as one patient's, and fails on the chunk's second row).  A regressor
and a detector are refused: the rows are class probabilities.

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

import numpy as np
import torch

from deepards_tpu_torch.data.pipeline import BatchPipeline
from deepards_tpu_torch.train.loop import make_trainer
from deepards_tpu_torch.train.nested_trainer import patient_groups
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
    if trainer.spec.super_batch:
        index, probs = _patient_probs(trainer, state, train_ds, test_ds)
    else:
        index, probs = _window_probs(trainer, state, train_ds, test_ds,
                                     batch_size)
    truth = test_ds.get_ground_truth()
    row_of = {int(w): k for k, w in enumerate(truth.index)}
    rows = []
    for widx, prob in zip(index, probs):
        k = row_of[int(widx)]
        rows.append({
            "window_index": int(widx),
            "patient": str(truth.patient[k]),
            "hour": float(truth.hour[k]),
            "prob_other": float(prob[0]),
            "prob_ards": float(prob[1]),
            "prediction": int(prob.argmax()),
        })
    return rows, patient_votes(rows)


def _window_probs(trainer, state, train_ds, test_ds, batch_size):
    """The test windows in order, in batches of ``batch_size`` through the
    trainer's eval step: (window indices, (n, 2) probabilities)."""
    _, eval_step = make_train_step(trainer.loss_fn,
                                   **trainer.step_options(train_ds))
    idxs = test_ds.current_indices()
    probs = []
    for start in range(0, len(idxs), batch_size):
        chunk = idxs[start:start + batch_size]
        batch = trainer.device_batch(test_ds.gather(chunk), batch_size)
        _, logits = eval_step(state, **batch)
        prob = torch.softmax(logits, dim=-1)[:len(chunk)]
        if prob.ndim == 3:  # a per-breath head: the mean of its windows
            prob = prob.mean(dim=1)
        probs.append(prob.cpu().numpy())
    return idxs, np.concatenate(probs)


def _patient_probs(trainer, state, train_ds, test_ds):
    """A nested network's test windows as its trainer evaluates them: one
    patient a super batch, patients sorted by id (eager steps)."""
    runners = trainer.nested_runners(
        state, BatchPipeline(train_ds, trainer.device),
        train_ds.cache.data.shape[1:], graphed=False)
    groups = patient_groups(test_ds)
    _, outs = trainer.patient_steps(runners, test_ds, groups, train=False)
    probs = torch.softmax(torch.cat(outs), dim=-1).cpu().numpy()
    return np.concatenate([idxs for _, idxs, _ in groups]), probs


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
