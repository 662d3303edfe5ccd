"""A protopnet_2d run through ``cli.train`` on the CPU against the JAX
package's ``ProtoPNetTrainer`` (``torch_2d_runs.py``), with the JAX
trainer's ``_make_tx`` replaced by the reference's staging as
``test_torch_protopnet_run.py`` does (its own moves every parameter
outside a stage).  2 folds, batch 4, 3 prototypes a class, the experiment
file's 2D transforms (mag_warp, row_shuffle, win_warp: both packages draw
them from the dataset's generator in the same order, in the epochs and
in the pushes), a schedule of 2 warm epochs, each followed by a push and
a last-layer epoch (no joint epoch: a run through one is
ill-conditioned, ``test_torch_protopnet_run.py``).  Per-step losses and
their parts within 1e-4; the pushes' winners (image, flat position over
H'*W') equal and their distances within 1e-4; votes, patient rows and
AUCs equal.

The transforms keep the last-layer epochs well conditioned: they see new
warps of the images the push read.  Without them a pushed prototype meets
its own patch again, where its distance ||x||^2 + ||p||^2 - 2<x, p> is
float32 rounding of ~50 (0 to ~1e-5, each package by its own summation
order) and the similarity log((d + 1) / (d + 1e-4)) has slope 1e4: the
two packages' losses then part by ~0.04 at the first step after a push,
with equal params and batches.
"""
import numpy as np
import pytest
import torch
from test_torch_protopnet_run import _reference_staging
from torch_2d_runs import (
    NumpyInit,
    assert_meters_close,
    assert_votes_equal,
    from_inits,
    narrow_backbones,
    overrides,
)

import deepards_tpu.models.protopnet2d as jprotopnet2d
import deepards_tpu.train.protopnet_trainer as jtrainer
from deepards_tpu.config import Configuration as JaxConfiguration
from deepards_tpu_torch.cli.train import main as train_main
from deepards_tpu_torch.train.protopnet_trainer import ProtoPNetTrainer

# parallel test workers share the cores: one torch thread each
torch.set_num_threads(1)

SCHEDULE = dict(epochs=2, n_warm_epochs=2, push_start_epoch=1,
                push_every_n=1, n_push_iters=1)
TRANSFORMS = ["mag_warp", "row_shuffle", "win_warp"]


def _flags(cohort, tmp_path):
    return [
        "--data-path", cohort["data_path"], "--cohort-file",
        cohort["cohort_file"], "--network", "protopnet_2d", "-nb", "4",
        "--kfolds", "2", "--batch-size", "4", "-lr", "0.0001", "-wd",
        "0.0001", "-np", "3", "--oversample-minority",
        "--compute-dtype", "float32", "--seed", "7", "--fused-steps", "1",
        "--epochs", "2", "--n-warm-epochs", "2", "-pse", "1",
        "--push-every-n", "1", "--n-push-iters", "1", "--device", "cpu",
        "--two-dim-transforms", *TRANSFORMS,
        "--results-dir", str(tmp_path / "results")]


def test_protopnet_2d_run_matches_jax(synthetic_cohort, tmp_path):
    inits, pushes, port_pushes = [], [], []
    construct = jprotopnet2d.construct_ppnet_2d
    push = jtrainer.ProtoPNetTrainer.push_prototypes
    port_push = ProtoPNetTrainer.push_prototypes

    def recording_push(self, *args):
        state = push(self, *args)
        pushes.append(self.last_push_info)
        return state

    with pytest.MonkeyPatch.context() as mp:
        narrow_backbones(mp)
        mp.setattr(jprotopnet2d, "construct_ppnet_2d",
                   lambda *a, **k: NumpyInit(construct(*a, **k), inits))
        mp.setattr(jtrainer.ProtoPNetTrainer, "_make_tx",
                   _reference_staging)
        mp.setattr(jtrainer.ProtoPNetTrainer, "push_prototypes",
                   recording_push)
        jres = jtrainer.ProtoPNetTrainer(JaxConfiguration(
            overrides=overrides(
                synthetic_cohort, tmp_path / "jax", network="protopnet_2d",
                batch_size=4, n_prototypes=3, incorrect_strength=-0.5,
                clust_lambda=0.8, sep_lambda=0.2,
                two_dim_transforms=TRANSFORMS, **SCHEDULE)),
            verbose=False).train_and_test()
        from_inits(ProtoPNetTrainer, inits, mp)
        mp.setattr(ProtoPNetTrainer, "push_prototypes",
                   lambda self, *a: port_pushes.append(
                       port_push(self, *a)) or port_pushes[-1])
        trainer = train_main(_flags(synthetic_cohort, tmp_path / "port"))
    assert isinstance(trainer, ProtoPNetTrainer)
    assert trainer.conf.base_network == "densenet18_2d"
    port = trainer.results
    prefixes = ("loss_epoch_", "test_loss_fold_", "cls_loss", "clst_loss",
                "sep_loss", "l1_loss")
    assert len(port_pushes) == len(pushes) == 4  # 2 a fold
    for mine, theirs in zip(port_pushes, pushes):
        assert [(i["window_index"], i["flat_pos"]) for i in mine] == \
            [(i["window_index"], i["flat_pos"]) for i in theirs]
        np.testing.assert_allclose([i["distance"] for i in mine],
                                   [i["distance"] for i in theirs],
                                   atol=1e-4, rtol=0)
    assert_meters_close(port, jres, prefixes, 2 * 7)
    assert_votes_equal(port, jres, 2 * 2 * 4)
