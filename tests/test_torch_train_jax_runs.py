"""Whole training runs of the port against the JAX package's, on the
shared synthetic cohort, as in ``test_torch_train_loop.py``:
cnn_linear/densenet18, S = 4, batch 8, float32, config 1's optimizer at
lr 1e-4 (where the run is well conditioned), dropout off on both sides,
and each fold of the port starting from the params the JAX trainer
initialised for it.  Per-step losses agree to 1e-4; patient rows and
AUCs are equal.

- ``--transforms ie_ww`` at ``fused_steps: 1``: both warp the same
  windows (the same host generator, drawn in the same order) in the host
  epoch.  One epoch: with the transforms mu is not subtracted, and the
  run is ~8x less well conditioned than without (a 1e-7 relative nudge
  of the init moves the port's own test losses by 7.7e-5 over 2 epochs,
  against 9.5e-6 without transforms), so over 2 epochs the two
  frameworks' roundings part by up to 1.4e-4;
- ``padded_breath_by_breath_with_flow_time_features``: the metadata
  input, through the device-cache epoch on both sides;
- the JAX package's fault, pinned: at ``fused_steps`` > 1 its host epoch
  never applies the transforms, while the port's does.
"""
import numpy as np
import pytest
import torch

import deepards_tpu.data.augment as jaugment
import deepards_tpu.train.loop as jloop
import deepards_tpu_torch.data.augment as taugment
import deepards_tpu_torch.train.loop as tloop
from deepards_tpu.config import Configuration as JaxConfiguration
from deepards_tpu_torch.config.config import Configuration
from deepards_tpu_torch.transplant import transplant

torch.set_num_threads(1)


def _overrides(cohort, tmp_path, **over):
    base = dict(
        data_path=cohort["data_path"], cohort_file=cohort["cohort_file"],
        experiment_num=1, network="cnn_linear", base_network="densenet18",
        dataset_type="unpadded_centered_sequences", n_sub_batches=4,
        kfolds=2, only_fold=1, epochs=2, batch_size=8, optimizer="sgd",
        learning_rate=0.0001, weight_decay=0.0001, clip_grad=True,
        clip_val=0.01, oversample_minority=True, compute_dtype="float32",
        dp_devices=1, results_dir=str(tmp_path / "results"), seed=7,
    )
    base.update(over)
    return base


def _no_dropout(make_train_step):
    def wrapped(*args, **kw):
        kw["dropout_active"] = False
        kw["eval_dropout_active"] = False
        return make_train_step(*args, **kw)
    return wrapped


def _counting(module, calls):
    apply = module.apply_to_batch

    def counted(*args):
        calls.append(1)
        return apply(*args)
    return counted


def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if hasattr(v, "items"):
            out.update(_flat(v, prefix + k + "/"))
        else:
            out[prefix + k] = np.asarray(v)
    return out


def _jax_run(cohort, tmp_path, **over):
    """The JAX trainer's results, the params it initialised per fold run,
    and the calls of its apply_to_batch."""
    inits, calls = [], []
    create = jloop.create_train_state

    def recording(*args, **kw):
        state = create(*args, **kw)
        inits.append(transplant(_flat(state.params)))
        return state

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jloop, "create_train_state", recording)
        mp.setattr(jloop, "make_train_step",
                   _no_dropout(jloop.make_train_step))
        mp.setattr(jaugment, "apply_to_batch", _counting(jaugment, calls))
        trainer = jloop.Trainer(JaxConfiguration(
            overrides=_overrides(cohort, tmp_path, **over)), verbose=False)
        results = trainer.train_and_test()
    return results, inits, calls


def _port_run(cohort, tmp_path, inits, **over):
    calls = []
    trainer = tloop.Trainer(Configuration(
        overrides=_overrides(cohort, tmp_path, **over)), device="cpu",
        verbose=False)
    runs = iter(inits)
    trainer.init_model = lambda model, fold: model.load_state_dict(
        next(runs))
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(tloop, "make_train_step",
                   _no_dropout(tloop.make_train_step))
        mp.setattr(taugment, "apply_to_batch", _counting(taugment, calls))
        trainer.train_and_test()
    return trainer.results, calls


def _meters(results, prefix):
    return {k: v.values for k, v in results.reporting.meters.items()
            if k.startswith(prefix)}


def _assert_runs_equal(port, jax_results, epochs):
    for prefix in ("loss_epoch_", "test_loss_fold_"):
        got, want = _meters(port, prefix), _meters(jax_results, prefix)
        assert got.keys() == want.keys() and got
        for name in want:
            np.testing.assert_allclose(got[name], want[name], atol=1e-4,
                                       rtol=0, err_msg=name)
    want = jax_results.results.to_dict(orient="records")
    assert port.results == want and len(want) == 4 * epochs
    auc = port.get_meter("test_auc", 1).values
    assert auc == jax_results.get_meter("test_auc", 1).values
    assert len(auc) == epochs


def test_transforms_run_matches_jax(synthetic_cohort, tmp_path):
    over = dict(transforms=["ie_ww"], transform_probability=0.5,
                fused_steps=1, epochs=1)
    jres, inits, jcalls = _jax_run(synthetic_cohort, tmp_path / "jax",
                                   **over)
    port, calls = _port_run(synthetic_cohort, tmp_path / "port", inits,
                            **over)
    # 108 windows: 14 batches, each warped once on each side
    assert len(calls) == len(jcalls) == 14
    _assert_runs_equal(port, jres, epochs=1)


def test_metadata_run_matches_jax(synthetic_cohort, tmp_path):
    over = dict(
        dataset_type="padded_breath_by_breath_with_flow_time_features",
        epochs=1)
    jres, inits, _ = _jax_run(synthetic_cohort, tmp_path / "jax", **over)
    assert inits[0]["head.weight"].shape == (2, 4 * (128 + 9))
    port, _ = _port_run(synthetic_cohort, tmp_path / "port", inits, **over)
    _assert_runs_equal(port, jres, epochs=1)


def test_jax_fused_host_epoch_skips_the_transforms(synthetic_cohort,
                                                   tmp_path):
    """The JAX package at fused_steps 4 trains on unwarped windows; the
    port warps every batch at any fused_steps."""
    over = dict(transforms=["ie_ww"], transform_probability=1.0,
                fused_steps=4, epochs=1)
    _, inits, jcalls = _jax_run(synthetic_cohort, tmp_path / "jax", **over)
    assert jcalls == []
    _, calls = _port_run(synthetic_cohort, tmp_path / "port", inits, **over)
    assert len(calls) == 14
