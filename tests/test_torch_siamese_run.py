"""Whole siamese runs of the port's trainer against the JAX package's.

A siamese_cnn_linear run on the shared synthetic cohort's ``main``
holdout (no folds, 2 epochs, batch 8, S = 4, float32, SGD at lr 1e-4)
over a narrow densenet without dropout (growth 8, one layer a block) in
both packages, the port from the params the JAX trainer initialised:
per-step train losses, and the test losses and accuracy by fold and by
epoch, within 1e-4.  The JAX trainer's two calls a step are pinned as
the port has them: one dropout key for both, and dropout on (``False``
as ``deterministic``) in training and in eval alike.  Shared with
``test_torch_siamese_pretrained.py``: the configuration and the narrow
backbone."""
import jax
import pytest
import torch
from torch_2d_runs import (
    NumpyInit,
    assert_meters_close,
    from_inits,
)

import deepards_tpu.models.registry as jregistry
import deepards_tpu.train.loop as jloop
import deepards_tpu.train.siamese_trainer as jsiamese_trainer
import deepards_tpu_torch.models.registry as tregistry
import deepards_tpu_torch.train.loop as tloop
from deepards_tpu.config import Configuration as JaxConfiguration
from deepards_tpu.models import densenet1d as jdensenet
from deepards_tpu_torch.config.config import Configuration
from deepards_tpu_torch.models import densenet1d
from deepards_tpu_torch.train.siamese_trainer import SiameseTrainer

# parallel test workers share the cores: one torch thread each
torch.set_num_threads(1)

NARROW = dict(growth_rate=8, block_config=(1, 1, 1, 1), num_init_features=16,
              drop_rate=0.0)


def _overrides(cohort, tmp_path, **over):
    base = dict(
        data_path=cohort["data_path"], cohort_file=cohort["cohort_file"],
        experiment_num=1, network="siamese_cnn_linear",
        base_network="densenet18",
        dataset_type="unpadded_centered_sequences", n_sub_batches=4,
        kfolds=None, epochs=2, batch_size=8, optimizer="sgd",
        learning_rate=0.0001, weight_decay=0.0001, clip_grad=True,
        clip_val=0.01, compute_dtype="float32", dp_devices=1,
        results_dir=str(tmp_path / "results"),
        saved_models_dir=str(tmp_path / "models"), seed=7)
    base.update(over)
    return base


def _narrow(mp):
    mp.setitem(jregistry.BASE_NETWORKS, "densenet18",
               lambda conf: jdensenet.DenseNet1D(**NARROW))
    mp.setitem(tregistry.BASE_NETWORKS, "densenet18",
               lambda conf, c: densenet1d.DenseNet1D(in_channels=c, **NARROW))


class Recording(NumpyInit):
    """``NumpyInit`` that also records each ``apply``'s ``deterministic``
    argument and its dropout key."""

    def __init__(self, module, inits, calls):
        super().__init__(module, inits)
        self._calls = calls

    def apply(self, variables, *args, rngs=None, **kw):
        self._calls.append((args[2], (rngs or {}).get("dropout")))
        return self._module.apply(variables, *args, rngs=rngs, **kw)


def test_siamese_run_matches_jax(synthetic_cohort, tmp_path):
    inits, calls = [], []
    build = jloop.Trainer.build_model
    with pytest.MonkeyPatch.context() as mp:
        _narrow(mp)
        mp.setattr(jsiamese_trainer.SiameseTrainer, "build_model",
                   lambda self: Recording(build(self), inits, calls))
        jtrainer = jloop.make_trainer(JaxConfiguration(overrides=_overrides(
            synthetic_cohort, tmp_path / "jax")), verbose=False)
        jres = jtrainer.train_and_test()
        from_inits(SiameseTrainer, inits, mp)
        trainer = tloop.make_trainer(Configuration(overrides=_overrides(
            synthetic_cohort, tmp_path / "port")), device="cpu",
            verbose=False)
        port = trainer.train_and_test()
    assert type(trainer) is SiameseTrainer and len(inits) == 1
    # the train losses, and the test losses and accuracy by fold and epoch
    assert_meters_close(port, jres, ("loss", "test_loss", "accuracy"), 7)
    steps = len(port.get_meter("loss", 0).values)
    assert steps == 2 * (trainer.last_train_count // 8)
    accuracy = port.get_meter("accuracy", 0).values
    assert len(accuracy) == 2 and all(0 <= a <= 1 for a in accuracy)
    # the JAX steps' calls, traced in pairs (positive, negative): dropout
    # on in every one, and one key a pair
    assert calls and len(calls) % 2 == 0
    assert all(deterministic is False for deterministic, _ in calls)
    for (_, key_pos), (_, key_neg) in zip(calls[::2], calls[1::2]):
        assert isinstance(key_pos, jax.core.Tracer) and key_pos is key_neg
