"""Evaluation of saved per-fold checkpoints as pseudo-epochs.

Counterpart of ``deepards_tpu/cli/evaluate.py`` (reference:
deepards/evaluate.py:15-50 and its evaluate_config yml, a
``models: {fold: [checkpoint, ...]}`` map):

  python -m deepards_tpu_torch.cli.evaluate -co evaluate.yml \\
      [--saved-models-dir saved_models]

The yml's ``train_from_pickle`` names a saved ``.npz`` dataset; each of a
fold's checkpoints (under --saved-models-dir) runs over the fold's test
windows as one pseudo-epoch through the trainer's eval step (a CUDA-graph
replay on the card) and ``Trainer.run_test_epoch``, its recording
deferred to the end of the fold.  Then the accuracy and AUC of each fold
over all its pseudo-epochs' patient rows (``eval.metrics``, no
scikit-learn) and the aggregated results, written as the trainer writes
them.  The yml's ``device`` key names the device (default: the card;
raises when there is none); ``evaluate`` takes a ``Configuration``, for a
caller without PyYAML.
"""
import argparse
import os

FOLD_COLUMNS = ["Fold", "Accuracy", "AUC"]


def evaluate(conf, device=None, saved_models_dir="saved_models"):
    """Every fold's checkpoints of ``conf.models`` as pseudo-epochs.
    Returns (fold rows of ``FOLD_COLUMNS``, the aggregated stats, the
    trainer, whose ``results`` hold the patient rows)."""
    import numpy as np

    from deepards_tpu_torch.data.dataset import ARDSRawDataset
    from deepards_tpu_torch.eval.metrics import _print_table, roc_auc
    from deepards_tpu_torch.train import checkpoint
    from deepards_tpu_torch.train.loop import Trainer
    from deepards_tpu_torch.train.steps import make_train_step

    dataset = ARDSRawDataset.from_pickle(conf.train_from_pickle)
    test_dataset = ARDSRawDataset.make_test_dataset_if_kfold(dataset)
    trainer = Trainer(conf, device=device, verbose=False)
    trainer.n_sub_batches = dataset.n_sub_batches
    trainer.in_channels = dataset.cache.data.shape[2]
    models = conf.get("models") or {}
    # fold count: the configuration's, else the dataset's own
    kfolds = conf.get("kfolds") or dataset.total_kfolds or 5
    for fold in range(kfolds):
        test_dataset.set_kfold_indexes_for_fold(fold)
        names = models.get(fold, [])
        if not names:
            continue
        state = trainer.new_state(fold)
        runner = trainer.make_runner(state, test_dataset, *make_train_step(
            trainer.loss_fn, **trainer.step_options(test_dataset)))
        with trainer.deferred_fetch():
            for i, name in enumerate(names):
                saved = checkpoint.restore(os.path.join(saved_models_dir,
                                                        name))
                # in place: the runner's graph reads these tensors
                state.model.load_state_dict(saved["params"])
                if "rng" in saved:
                    state.generator.set_state(saved["rng"])
                trainer.run_test_epoch(runner, test_dataset, fold, i)

    rows = []
    for fold in dict.fromkeys(r["fold_num"] for r in trainer.results.results):
        mine = [r for r in trainer.results.results if r["fold_num"] == fold]
        patho = np.asarray([r["patho"] for r in mine])
        pred = np.asarray([r["prediction"] for r in mine])
        auc = roc_auc(patho, [r["pred_frac"] for r in mine])
        rows.append(dict(zip(FOLD_COLUMNS, [
            fold, round(float((patho == pred).mean()), 4),
            auc if np.isnan(auc) else round(auc, 4)])))
    print("\nMean Results")
    _print_table(rows, FOLD_COLUMNS)
    print("\nAggregated Results")
    aggregate = trainer.results.aggregate_classification_results()
    return rows, aggregate, trainer


def main(argv=None):
    parser = argparse.ArgumentParser(prog="deepards-evaluate-torch")
    parser.add_argument("-co", "--config-override", required=True)
    parser.add_argument("--saved-models-dir", default="saved_models")
    args = parser.parse_args(argv)

    from deepards_tpu_torch.config.config import Configuration

    conf = Configuration(argparse.Namespace(
        config_override=args.config_override))
    return evaluate(conf, conf.get("device"), args.saved_models_dir)


if __name__ == "__main__":
    main()
