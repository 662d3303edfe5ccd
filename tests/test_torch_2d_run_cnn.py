"""A cnn_linear_2d run through the port's trainer against the JAX
package's (``torch_2d_runs.py``: 2 folds of the shared cohort, 2 epochs,
batch 2, narrow densenet18_2d, host epochs on both sides): per-step train
and test losses within 1e-4, votes, patient rows and AUCs equal."""
import pytest
import torch
from torch_2d_runs import (
    assert_meters_close,
    assert_votes_equal,
    flat_params,
    from_inits,
    narrow_backbones,
    overrides,
)

import deepards_tpu.train.loop as jloop
import deepards_tpu_torch.train.loop as tloop
from deepards_tpu.config import Configuration as JaxConfiguration
from deepards_tpu_torch.config.config import Configuration
from deepards_tpu_torch.transplant import transplant

# parallel test workers share the cores: one torch thread each
torch.set_num_threads(1)


def test_cnn_linear_2d_run_matches_jax(synthetic_cohort, tmp_path):
    over = dict(network="cnn_linear_2d")
    inits = []
    create = jloop.create_train_state

    def recording(*args, **kw):
        state = create(*args, **kw)
        inits.append(transplant(flat_params(state.params)))
        return state

    with pytest.MonkeyPatch.context() as mp:
        narrow_backbones(mp)
        mp.setattr(jloop, "create_train_state", recording)
        jres = jloop.Trainer(JaxConfiguration(overrides=overrides(
            synthetic_cohort, tmp_path / "jax", **over)),
            verbose=False).train_and_test()
        from_inits(tloop.Trainer, inits, mp)
        trainer = tloop.Trainer(Configuration(overrides=overrides(
            synthetic_cohort, tmp_path / "port", **over)), device="cpu",
            verbose=False)
        port = trainer.train_and_test()
    assert len(inits) == 2
    assert trainer.conf.base_network == "densenet18_2d"
    # 2 epochs' train losses and the test losses, of each fold
    assert_meters_close(port, jres, ("loss_epoch_", "test_loss_fold_"),
                        3 * 2)
    assert_votes_equal(port, jres, 2 * 2 * 4)
