"""cnn_transformer's trainer against the JAX package's: 2 folds x 1
epoch of the shared synthetic cohort at lr 1e-4, over resnet18 at 8
initial planes, S = 4, float32, dropout off (the trainers' steps with
dropout inactive, which turns off the transformer's fixed 0.2 too), both
from the same numpy-drawn params.  Per-step losses within 1e-4; votes,
patient rows, AUCs and predictions by hour equal
(``test_torch_configs_2_3_4.assert_classifier_run_matches_jax``).  In a
file of its own: the JAX trainer compiles its steps anew for each fold.
"""
import torch
from test_torch_configs_2_3_4 import assert_classifier_run_matches_jax

# parallel test workers share the cores: one torch thread each
torch.set_num_threads(1)


def test_cnn_transformer_run_matches_jax(synthetic_cohort, tmp_path):
    """Per-window logits (B, S, 2): each window's index repeats S = 4
    times in the predictions."""
    trainer = assert_classifier_run_matches_jax(
        synthetic_cohort, tmp_path, "cnn_transformer", dict(
            network="cnn_transformer", base_network="resnet18",
            initial_planes=8, time_series_hidden_units=16,
            dataset_type="unpadded_centered_sequences"))
    assert trainer.last_eval["logits"].shape[1:] == (4, 2)
