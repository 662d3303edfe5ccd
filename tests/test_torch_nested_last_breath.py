"""The nested trainer with ``loss_calc: last_breath`` against the JAX
package's: cnn_to_nested_rnn, one fold of ``test_torch_nested_run.py``'s
run, each patient's loss the last real window's logits against its
target.  Per-step train and test losses within 1e-4; votes, patient rows,
AUCs and predictions by hour equal.  In a file of its own: the JAX
trainer compiles its steps anew for each bucket.
"""
import torch
from test_torch_nested_run import _assert_run_matches, _runs, cohort  # noqa

# parallel test workers share the cores: one torch thread each
torch.set_num_threads(1)


def test_nested_last_breath_run_matches_jax(cohort, tmp_path):  # noqa: F811
    jres, trainer = _runs(cohort, tmp_path, network="cnn_to_nested_rnn",
                          loss_calc="last_breath", only_fold=0)
    _assert_run_matches(jres, trainer, (0,))
