"""Benchmark config 4's trainer (cnn_lstm: per-breath logits against the
target repeated over the windows, eval with dropout off) against the JAX
package's: 2 folds x 1 epoch of the shared synthetic cohort at lr 1e-4,
over resnet18 at 8 initial planes (densenet18 under cnn_lstm is held in
``test_torch_configs_2_3_4.py``'s steps), S = 4, float32, dropout off,
both trainers from the same numpy-drawn params.  Per-step losses within
1e-4; votes, patient rows, AUCs and predictions by hour equal
(``test_torch_configs_2_3_4.assert_classifier_run_matches_jax``).  In a
file of its own: the JAX trainer traces and compiles its steps anew for
each fold.
"""
import torch
from test_torch_configs_2_3_4 import assert_classifier_run_matches_jax

# parallel test workers share the cores: one torch thread each
torch.set_num_threads(1)


def test_config4_run_matches_jax(synthetic_cohort, tmp_path):
    """Each window's index repeats S = 4 times in the predictions."""
    trainer = assert_classifier_run_matches_jax(synthetic_cohort, tmp_path,
                                                "config4")
    assert trainer.last_eval["logits"].shape[1:] == (4, 2)
    rows = trainer.results.all_pred_to_hour
    assert sum(r["fold"] == 1 for r in rows) == 4 * len(
        trainer.last_eval["index"])
