"""``--perform-dtw-preprocessing`` across the trainers whose JAX runs
save predictions by hour.

The JAX package calls the hook after the folds of every trainer
(``deepards_tpu/train/loop.py:330``, ``parallel_folds.py:302``).  The
parallel-fold run is held to the JAX one's cached frames (the comparison
of ``test_torch_dtw_preprocessing.py``); the nested trainer (here) and the
ProtoPNet trainer (``test_torch_dtw_preprocessing_refused.py``) write the
frames of their last predictions.
"""
import numpy as np
import torch
from test_torch_dtw_preprocessing import (
    assert_run_frames,
    run_flags,
    whole_runs,
)

from deepards_tpu_torch.cli import train as ttrain
from deepards_tpu_torch.eval import plots

# parallel test workers share the cores: one torch thread each
torch.set_num_threads(1)


def test_parallel_folds_run_matches_jax(synthetic_cohort, tmp_path):
    trainer, want = whole_runs(synthetic_cohort, tmp_path,
                               ["--parallel-folds"])
    assert type(trainer).__name__ == "ParallelFoldTrainer"
    assert_run_frames(trainer, want, tmp_path)


def assert_frames_of_last_predictions(synthetic_cohort, tmp_path, extra):
    """A 2-fold port run of ``extra``'s network: its frames are those of
    its last predictions on the last fold's test split."""
    trainer = ttrain.main(run_flags(synthetic_cohort, extra) + [
        "--results-dir", str(tmp_path / "r"), "--device", "cpu"])
    test = trainer.get_base_datasets()[1]
    test.set_kfold_indexes_for_fold(1)
    again = plots.perform_dtw_preprocessing(
        trainer.results, test, str(tmp_path / "again"), device="cpu")
    assert list(trainer.dtw_frames) == list(again) and again
    for pt, frame in again.items():
        np.testing.assert_array_equal(trainer.dtw_frames[pt].index,
                                      frame.index)
        np.testing.assert_array_equal(trainer.dtw_frames[pt].dtw, frame.dtw)


def test_nested_trainer_writes_frames(synthetic_cohort, tmp_path,
                                      monkeypatch):
    monkeypatch.chdir(tmp_path)
    assert_frames_of_last_predictions(synthetic_cohort, tmp_path,
                                      ["--network", "cnn_to_nested_rnn"])
