"""A retinanet_2d run through the port's ``DetectorTrainer`` against the
JAX package's (``torch_2d_runs.py``: 2 folds, 2 epochs, batch 2, the bbox
splices of both splits, sigmoid focal loss): per-step train losses and
the test losses within 1e-4, the train and test splits' band IoU of each
epoch within 1e-6."""
import numpy as np
import pytest
import torch
from torch_2d_runs import (
    NumpyInit,
    assert_meters_close,
    from_inits,
    narrow_backbones,
    overrides,
)

import deepards_tpu.models.registry as jregistry
import deepards_tpu.train.detector_trainer as jdetector
import deepards_tpu.train.loop as jloop
from deepards_tpu.config import Configuration as JaxConfiguration
from deepards_tpu_torch.config.config import Configuration
from deepards_tpu_torch.train.detector_trainer import DetectorTrainer
from deepards_tpu_torch.train.loop import make_trainer

# parallel test workers share the cores: one torch thread each
torch.set_num_threads(1)


@pytest.mark.parametrize("network", ["retinanet_2d"])
def test_detector_run_matches_jax(synthetic_cohort, tmp_path, network):
    inits = []
    spec = jregistry.NETWORK_MAP[network]
    over = dict(network=network, fl_gamma=2.0, fl_alpha=0.25)
    with pytest.MonkeyPatch.context() as mp:
        narrow_backbones(mp)
        mp.setattr(spec, "build", lambda *a, build=spec.build: NumpyInit(
            build(*a), inits))
        jtrainer = jloop.make_trainer(JaxConfiguration(overrides=overrides(
            synthetic_cohort, tmp_path / "jax", **over)), verbose=False)
        assert isinstance(jtrainer, jdetector.DetectorTrainer)
        jres = jtrainer.train_and_test()
        from_inits(DetectorTrainer, inits, mp)
        trainer = make_trainer(Configuration(overrides=overrides(
            synthetic_cohort, tmp_path / "port", **over)), device="cpu",
            verbose=False)
        port = trainer.train_and_test()
    assert isinstance(trainer, DetectorTrainer) and len(inits) == 2
    # train losses and test losses of each fold
    assert_meters_close(port, jres, ("loss_fold_", "test_loss_fold_"), 2 * 2)
    # by fold and by epoch, of each split
    assert_meters_close(port, jres, ("band_iou",), 2 * 2 * 2, atol=1e-6)
    ious = [v for k, v in port.reporting.meters.items()
            if k.startswith("band_iou")]
    assert all(len(v.values) == 2 and 0 < min(v.values) <= max(v.values)
               <= 1 for v in ious)
    assert np.isfinite(port.get_meter("loss", 0).values).all()
