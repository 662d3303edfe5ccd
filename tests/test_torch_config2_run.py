"""Benchmark config 2's trainer (cnn_linear over resnet18 on padded
breaths, Nesterov SGD with the 0.01 clamp) against the JAX package's: 2
folds x 1 epoch of the shared synthetic cohort at lr 1e-4, resnet18 at 8
initial planes, S = 4, float32, dropout off, both trainers from the same
numpy-drawn params.  Per-step losses within 1e-4; votes, patient rows,
AUCs and predictions by hour equal
(``test_torch_configs_2_3_4.assert_classifier_run_matches_jax``).  In a
file of its own: the JAX trainer traces and compiles its steps anew for
each fold.
"""
import torch
from test_torch_configs_2_3_4 import assert_classifier_run_matches_jax

# parallel test workers share the cores: one torch thread each
torch.set_num_threads(1)


def test_config2_run_matches_jax(synthetic_cohort, tmp_path):
    trainer = assert_classifier_run_matches_jax(synthetic_cohort, tmp_path,
                                                "config2")
    assert trainer.last_eval["logits"].shape[1:] == (2,)
    assert trainer.final_state.model.breath_block.n_out_filters == 64
