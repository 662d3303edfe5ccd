"""A ProtoPNet run (benchmark config 5's trainer) through ``cli.train`` on
the CPU against the JAX package's ``ProtoPNetTrainer``.

The JAX trainer's ``_make_tx`` is replaced here by the reference's
staging (an optimizer a stage over its own group, ``optax.multi_transform``
with ``set_to_zero`` elsewhere), since its own moves every parameter
outside a stage (``test_torch_protopnet.py``); no file of the JAX package
changes.  2 folds of the shared synthetic cohort, S = 4, float32, lr 1e-4,
densenet18 with dropout off in both packages, each fold of the port from
the JAX trainer's numpy-drawn params, and a schedule of 2 warm epochs,
each followed by a push and a last-layer epoch.  Per-step losses and
their parts within 1e-4; the pushes' winners equal and their distances
within 1e-4; votes, patient rows and AUCs equal.

No joint epoch: a run through one is ill-conditioned.  The port against
itself, its init nudged by 1e-7 of each value, parts by more than 1e-4 in
the first joint epoch at lr 1e-4, 1e-5 and 1e-6 alike, where this
schedule parts by at most 2.4e-5 (``python -m
deepards_tpu_torch.train.ppnet_spread``).  The joint stage's step is held
by ``test_torch_protopnet.py``.
"""
import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from test_torch_configs_2_3_4 import random_params

import deepards_tpu.models.registry as jregistry
import deepards_tpu.train.protopnet_trainer as jtrainer
import deepards_tpu_torch.models.registry as tregistry
from deepards_tpu.config import Configuration as JaxConfiguration
from deepards_tpu.models import densenet1d as jdensenet
from deepards_tpu_torch.cli.train import main as train_main
from deepards_tpu_torch.models import densenet1d
from deepards_tpu_torch.train.protopnet_trainer import ProtoPNetTrainer
from deepards_tpu_torch.transplant import transplant

# parallel test workers share the cores: one torch thread each
torch.set_num_threads(1)

S = 4
SCHEDULE = dict(epochs=2, n_warm_epochs=2, push_start_epoch=1,
                push_every_n=1, n_push_iters=1)


class _NumpyInit:
    """A flax PPNet whose ``init`` gives numpy-drawn params (prototypes
    uniform in [0, 1)), each recorded transplanted."""

    def __init__(self, module, inits):
        self._module = module
        self._inits = inits

    def __getattr__(self, name):
        return getattr(self._module, name)

    def init(self, rngs, x, *args):
        params = random_params(self._module, len(self._inits), x, *args)
        params["prototype_vectors"] = np.random.default_rng(
            len(self._inits)).uniform(
                size=params["prototype_vectors"].shape).astype(np.float32)
        self._inits.append(transplant(params))
        return {"params": params}


def _reference_staging(self, params):
    """Each stage's SGD over its own group, zero updates elsewhere
    (reference: train_ards_detector.py:1158-1192)."""
    lr = self.conf.get("learning_rate", 0.001)
    wd = self.conf.get("weight_decay", 0.0001)
    masks = jtrainer._param_stage_masks(params)
    return {stage: optax.multi_transform(
        {"on": optax.chain(optax.add_decayed_weights(wd),
                           optax.sgd(lr, momentum=0.9, nesterov=True)),
         "off": optax.set_to_zero()},
        jax.tree_util.tree_map(lambda m: "on" if m else "off",
                               masks[stage]))
        for stage in jtrainer.STAGES}


def _overrides(cohort, tmp_path):
    return dict(
        data_path=cohort["data_path"], cohort_file=cohort["cohort_file"],
        experiment_num=1, network="protopnet", base_network="densenet18",
        dataset_type="unpadded_centered_sequences", n_sub_batches=S,
        kfolds=2, batch_size=8, learning_rate=0.0001, weight_decay=0.0001,
        n_prototypes=10, incorrect_strength=-0.5, clust_lambda=0.8,
        sep_lambda=0.2, compute_dtype="float32", dp_devices=1,
        results_dir=str(tmp_path / "results"), seed=7, **SCHEDULE)


def _flags(cohort, tmp_path):
    return [
        "--data-path", cohort["data_path"], "--cohort-file",
        cohort["cohort_file"], "--network", "protopnet", "-nb", str(S),
        "--kfolds", "2", "--batch-size", "8", "-lr", "0.0001", "-wd",
        "0.0001", "-np", "10", "-ic", "-0.5", "--clust-lambda", "0.8",
        "--sep-lambda", "0.2", "--compute-dtype", "float32", "--seed", "7",
        "--epochs", "2", "--n-warm-epochs", "2", "-pse", "1",
        "--push-every-n", "1", "--n-push-iters", "1", "--device", "cpu",
        "--results-dir", str(tmp_path / "results")]


def _meters(results, prefixes):
    return {k: v.values for k, v in results.reporting.meters.items()
            if k.startswith(prefixes)}


def test_protopnet_run_matches_jax_reference_staging(synthetic_cohort,
                                                     tmp_path):
    inits, pushes = [], []
    construct = jtrainer.construct_ppnet
    push = jtrainer.ProtoPNetTrainer.push_prototypes

    def recording_push(self, *args):
        state = push(self, *args)
        pushes.append(self.last_push_info)
        return state

    with pytest.MonkeyPatch.context() as mp:
        mp.setitem(jregistry.BASE_NETWORKS, "densenet18",
                   lambda conf: jdensenet.densenet18(drop_rate=0.0))
        mp.setitem(tregistry.BASE_NETWORKS, "densenet18",
                   lambda conf, c: densenet1d.densenet18(in_channels=c,
                                                         drop_rate=0.0))
        mp.setattr(jtrainer, "construct_ppnet",
                   lambda *a, **k: _NumpyInit(construct(*a, **k), inits))
        mp.setattr(jtrainer.ProtoPNetTrainer, "_make_tx",
                   _reference_staging)
        mp.setattr(jtrainer.ProtoPNetTrainer, "push_prototypes",
                   recording_push)
        jres = jtrainer.ProtoPNetTrainer(JaxConfiguration(
            overrides=_overrides(synthetic_cohort, tmp_path / "jax")),
            verbose=False).train_and_test()
        runs = iter(inits)
        port_pushes = []
        port_push = ProtoPNetTrainer.push_prototypes
        mp.setattr(ProtoPNetTrainer, "init_model",
                   lambda self, model, fold: model.load_state_dict(
                       next(runs)))
        mp.setattr(ProtoPNetTrainer, "push_prototypes",
                   lambda self, *a: port_pushes.append(
                       port_push(self, *a)) or port_pushes[-1])
        trainer = train_main(_flags(synthetic_cohort, tmp_path / "port"))
    assert isinstance(trainer, ProtoPNetTrainer)
    port = trainer.results
    prefixes = ("loss_epoch_", "test_loss_fold_", "cls_loss", "clst_loss",
                "sep_loss", "l1_loss")
    got, want = _meters(port, prefixes), _meters(jres, prefixes)
    assert got.keys() == want.keys() and len(got) == 2 * 7
    for name in want:
        np.testing.assert_allclose(got[name], want[name], atol=1e-4, rtol=0,
                                   err_msg=name)
    assert len(port_pushes) == len(pushes) == 4  # 2 a fold
    for mine, theirs in zip(port_pushes, pushes):
        assert [(i["window_index"], i["flat_pos"]) for i in mine] == \
            [(i["window_index"], i["flat_pos"]) for i in theirs]
        np.testing.assert_allclose([i["distance"] for i in mine],
                                   [i["distance"] for i in theirs],
                                   atol=1e-4, rtol=0)
    want = jres.results.to_dict(orient="records")
    assert port.results == want and len(want) == 2 * 2 * 4
    for fold in (0, 1):
        assert port.get_meter("test_auc", fold).values == \
            jres.get_meter("test_auc", fold).values
