"""The nested whole-patient networks and their trainer's pieces against
the JAX package (``deepards_tpu/models/nested.py``,
``deepards_tpu/train/nested_trainer.py``).

Parameters are numpy draws in the flax trees' shapes, carried over with
``transplant``; the backbone is a narrow resnet18 (``initial_planes`` 8),
S = 4 (an even S: ``jnp.median`` takes the mean of the two middle
values), float32, dropout off.  ``SimpleCell`` alone, each network's
per-window logits of a patient with pad windows, and one train step of
each (its loss and every param) within 1e-5, the JAX side of the step
composed as the JAX trainer's ``loss_wrap`` composes it (the whole runs
of ``test_torch_nested_run.py`` hold the trainer itself).  The patient
order, checkpoint save, reload and continue, and ``--parallel-folds``
with a nested network (the JAX package fails; the port refuses it by
name).
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pandas as pd
import pytest
import torch
from flax import linen as flax_nn
from test_torch_configs_2_3_4 import (
    assert_round_trip,
    jit_apply,
    random_params,
    windows,
)

import deepards_tpu.train.nested_trainer as jnested_trainer
from deepards_tpu.config import Configuration as JaxConfiguration
from deepards_tpu.models import nested as jnested
from deepards_tpu.models import resnet1d as jresnet
from deepards_tpu.train import losses as jlosses
from deepards_tpu.train import steps as jsteps
from deepards_tpu.train.loop import make_trainer as jax_make_trainer
from deepards_tpu_torch.config.config import Configuration
from deepards_tpu_torch.data.dataset import GroundTruth
from deepards_tpu_torch.data.synthetic import generate_cohort
from deepards_tpu_torch.models import nested, recurrent, resnet1d
from deepards_tpu_torch.train import checkpoint
from deepards_tpu_torch.train import losses
from deepards_tpu_torch.train.loop import make_trainer
from deepards_tpu_torch.train.nested_trainer import (
    NestedTrainer,
    make_nested_steps,
    patient_groups,
)
from deepards_tpu_torch.train.steps import TrainState, make_optimizer
from deepards_tpu_torch.transplant import transplant

# parallel test workers share the cores: one torch thread each
torch.set_num_threads(1)

W, PAD, S, L, PLANES, H = 5, 3, 4, 224, 8, 16


def _t(x):
    return torch.from_numpy(np.asarray(x))


NETWORKS = {
    "cnn_to_nested_rnn": (jnested.CNNToNestedRNNNetwork,
                          nested.CNNToNestedRNNNetwork),
    "cnn_to_nested_lstm": (jnested.CNNToNestedLSTMNetwork,
                           nested.CNNToNestedLSTMNetwork),
    "cnn_to_nested_transformer": (jnested.CNNToNestedTransformerNetwork,
                                  nested.CNNToNestedTransformerNetwork),
}


def _pair(name):
    jcls, cls = NETWORKS[name]
    return (jcls(breath_block=jresnet.resnet18(initial_planes=PLANES)),
            cls(resnet1d.resnet18(initial_planes=PLANES)))


def _patient(seed):
    """A patient of W windows padded to W + PAD with zero windows, its
    mask."""
    x = np.zeros((1, W + PAD, S, 1, L), np.float32)
    x[0, :W] = windows(seed, (W, S, 1, L)) * 3
    mask = np.zeros((1, W + PAD), np.float32)
    mask[0, :W] = 1.0
    return x, mask


class JaxSimpleRNN(flax_nn.Module):
    @flax_nn.compact
    def __call__(self, x):
        return flax_nn.RNN(flax_nn.SimpleCell(features=H))(x)


def test_simple_cell_matches_flax():
    """flax's SimpleCell: the bias on Dense ``i``, none on ``h``, tanh,
    a zero carry."""
    x = windows(0, (3, 6, 24))
    jrnn = JaxSimpleRNN()
    params = random_params(jrnn, 1, jnp.asarray(x))
    assert set(params["SimpleCell_0"]["i"]) == {"kernel", "bias"}
    assert set(params["SimpleCell_0"]["h"]) == {"kernel"}
    want = jax.jit(lambda p, v: jrnn.apply({"params": p}, v))(
        params, jnp.asarray(x))
    model = torch.nn.ModuleDict({"rnn": recurrent.SimpleRNN(24, H)})
    model.load_state_dict(transplant(params))
    with torch.no_grad():
        got = model["rnn"](_t(x)).numpy()
    np.testing.assert_allclose(got, np.asarray(want), atol=1e-5, rtol=0)
    init = recurrent.SimpleRNN(128, H).reset_parameters(
        torch.Generator().manual_seed(0))
    w = init.hidden.weight.detach()
    torch.testing.assert_close(w @ w.T, torch.eye(H), atol=1e-5, rtol=0)
    assert torch.equal(init.input.bias, torch.zeros(H))


def test_window_medians_match_jnp_median():
    """At S = 4 the mean of the two middle values (not the lower one), its
    gradient half to each of them."""
    feats = windows(2, (W, S, 7))
    weights = windows(3, (W, 7))
    want = np.asarray(jnp.median(jnp.asarray(feats), axis=1))
    want_grad = np.asarray(jax.grad(lambda f: (jnp.median(f, axis=1)
                                               * weights).sum())(
        jnp.asarray(feats)))
    x = _t(feats).requires_grad_(True)
    got = nested.window_medians(x)
    (got * _t(weights)).sum().backward()
    np.testing.assert_allclose(got.detach().numpy(), want, atol=1e-6, rtol=0)
    np.testing.assert_allclose(x.grad.numpy(), want_grad, atol=1e-6, rtol=0)
    lower = torch.sort(_t(feats), dim=1).values[:, (S - 1) // 2].numpy()
    assert np.abs(lower - want).max() > 1e-2
    odd = windows(4, (W, 5, 7))
    np.testing.assert_allclose(nested.window_medians(_t(odd)).numpy(),
                               np.median(odd, axis=1), atol=1e-6, rtol=0)


@pytest.mark.parametrize("name", sorted(NETWORKS))
def test_nested_forward_matches_flax(name):
    """(1, W + PAD, S, 1, L) with PAD zero windows: every window's logits,
    the transformer's under its window mask; the real windows' logits are
    those of the unpadded patient."""
    jmodel, model = _pair(name)
    x, mask = _patient(5)
    params = random_params(jmodel, 6, jnp.asarray(x), None, True)
    assert "breath_block" in params  # one backbone shared by the windows
    want = jit_apply(jmodel, None, True, window_mask=jnp.asarray(mask > 0))(
        params, jnp.asarray(x), None)
    assert_round_trip(params, model)
    with torch.no_grad():
        got = model(_t(x), True, window_mask=_t(mask > 0)).numpy()
        own = model(_t(x[:, :W]), True,
                    window_mask=_t(mask[:, :W] > 0)).numpy()
    assert got.shape == (1, W + PAD, 2)
    np.testing.assert_allclose(got, np.asarray(want), atol=1e-5, rtol=0)
    np.testing.assert_allclose(got[:, :W], own, atol=1e-5, rtol=0)


def _jax_nested_step(jmodel, tx, last_breath):
    """One train step as ``deepards_tpu/train/nested_trainer.py``'s
    ``loss_wrap`` and ``train_step`` compose it (unit normalization,
    dropout off)."""
    loss_fn = jlosses.bce_with_logits

    def loss_wrap(params, data, target, wmask):
        out = jmodel.apply({"params": params}, data, None, True,
                           window_mask=wmask.astype(bool)).astype(
                               jnp.float32)
        if last_breath:
            last_real = jnp.maximum(wmask[0].sum().astype(jnp.int32), 1)
            logits = jnp.take(out[0], last_real - 1, axis=0)[None]
            return loss_fn(logits, target)
        t = jnp.repeat(target, out.shape[1], axis=0)
        return loss_fn(out[0], t, wmask[0])

    @jax.jit
    def step(params, opt_state, data, target, wmask):
        loss, grads = jax.value_and_grad(loss_wrap)(params, data, target,
                                                    wmask)
        updates, opt_state = tx.update(grads, opt_state, params)
        return optax.apply_updates(params, updates), opt_state, loss

    return step


@pytest.mark.parametrize("name,last_breath", [
    ("cnn_to_nested_rnn", False), ("cnn_to_nested_lstm", False),
    ("cnn_to_nested_transformer", False), ("cnn_to_nested_lstm", True),
])
def test_nested_train_steps_match_jax(name, last_breath):
    """Two steps (patients of W real windows in a bucket of W + PAD):
    losses and every param within 1e-5 after each."""
    opts = dict(learning_rate=0.001, weight_decay=0.0001, clip_grad=True,
                clip_val=0.01)
    jmodel, model = _pair(name)
    x, mask = _patient(7)
    params = random_params(jmodel, 8, jnp.asarray(x), None, True)
    tx = jsteps.make_optimizer("sgd", **opts)
    opt_state = tx.init(params)
    jstep = _jax_nested_step(jmodel, tx, last_breath)
    model.load_state_dict(transplant(params))
    state = TrainState(model, make_optimizer(model.parameters(), "sgd",
                                             **opts), torch.Generator())
    train_step, _ = make_nested_steps(losses.bce_with_logits,
                                      last_breath=last_breath,
                                      dropout_active=False)
    for k in range(2):
        data, _ = _patient(9 + k)
        target = np.eye(2, dtype=np.float32)[[k % 2]]
        params, opt_state, jloss = jstep(params, opt_state, jnp.asarray(data),
                                         jnp.asarray(target),
                                         jnp.asarray(mask))
        tloss = train_step(state, _t(data), _t(target), _t(mask))
        assert abs(float(tloss) - float(jloss)) <= 1e-5, (k, tloss, jloss)
        want = transplant(jax.tree_util.tree_map(np.asarray, params))
        for key, v in model.state_dict().items():
            np.testing.assert_allclose(v.numpy(), want[key].numpy(),
                                       atol=1e-5, rtol=0,
                                       err_msg="{} {}".format(k, key))


def test_buckets_are_powers_of_two():
    assert [nested.bucket(n) for n in (0, 1, 2, 3, 5, 16, 17, 1440)] == \
        [1, 1, 2, 4, 8, 16, 32, 2048]
    assert [jnested_trainer._bucket(n) for n in (1, 3, 17, 1440)] == \
        [1, 4, 32, 2048]


class _Truth:
    """A dataset's ground truth, as each package reads it."""

    def __init__(self, patients, y):
        self.index = np.array([4, 9, 2, 7, 3, 11, 5])[:len(patients)]
        self.patients = np.array(patients)
        self.y = np.array(y)

    def get_ground_truth(self):
        return GroundTruth(index=self.index, patient=self.patients, y=self.y,
                           hour=np.zeros(len(self.y), np.float32))

    def get_ground_truth_df(self):
        return pd.DataFrame({"patient": self.patients, "y": self.y,
                             "hour": 0.0}, index=self.index)


def test_patient_groups_sort_ids_as_the_jax_groupby():
    """Ids whose sorted order is not their order of first appearance
    ('b' first, '10' before '9' as strings): patients sorted, each with
    its windows in the truth's order and its first row's class."""
    truth = _Truth(["b", "9", "b", "10", "a", "9", "a"],
                   [1, 0, 0, 1, 0, 1, 1])
    got = patient_groups(truth)
    want = jnested_trainer.NestedTrainer._patient_groups(None, truth)
    assert [g[0] for g in got] == ["10", "9", "a", "b"]
    assert len(got) == len(want)
    for (p, idx, y), (jp, jidx, jy) in zip(got, want):
        assert (p, y) == (jp, jy)
        np.testing.assert_array_equal(idx, jidx)


@pytest.fixture(scope="module")
def small_cohort(tmp_path_factory):
    """8 patients of 60 breaths: 15 windows each at S = 4."""
    data_path = str(tmp_path_factory.mktemp("nested_cohort"))
    cohort_file = generate_cohort(data_path, n_patients=8,
                                  n_breaths_per_patient=60, seed=11)
    return {"data_path": data_path, "cohort_file": cohort_file}


def _overrides(cohort, tmp_path, **over):
    base = dict(
        data_path=cohort["data_path"], cohort_file=cohort["cohort_file"],
        experiment_num=1, network="cnn_to_nested_lstm",
        base_network="resnet18", initial_planes=PLANES,
        dataset_type="unpadded_centered_sequences", n_sub_batches=S,
        kfolds=2, only_fold=0, epochs=2, batch_size=4,
        compute_dtype="float32", results_dir=str(tmp_path / "results"),
        seed=3, oversample_minority=True)
    base.update(over)
    return base


def _port(cohort, tmp_path, **over):
    return make_trainer(Configuration(overrides=_overrides(
        cohort, tmp_path, **over)), device="cpu", verbose=False)


def test_nested_checkpoint_save_reload_continue(small_cohort, tmp_path):
    """As ``tests/test_checkpoint_modes.py``'s nested case: per-epoch and
    final checkpoints; the final one evaluates with no training; and a
    run continued from epoch 1's checkpoint repeats the run's second
    epoch exactly (losses, test losses, the final params)."""
    models = str(tmp_path / "models")
    first = _port(small_cohort, tmp_path / "a", save_model="nm",
                  save_model_per_epoch=True, saved_models_dir=models)
    assert isinstance(first, NestedTrainer)
    first.train_and_test()
    losses_run = first.results.get_meter("loss", 0).values
    per_epoch = len(losses_run) // 2
    assert per_epoch and len(losses_run) == 2 * per_epoch
    for name in ("nm-epoch1-fold0", "nm-epoch2-fold0", "nm-fold0"):
        assert checkpoint.load_scaling(models + "/" + name) is not None
    evaluated = _port(small_cohort, tmp_path / "b",
                      load_checkpoint=models + "/nm-fold0", no_train=True,
                      epochs=1)
    evaluated.train_and_test()
    assert len(evaluated.results.get_meter("loss", 0)) == 0
    assert len(evaluated.results.get_meter("test_auc", 0)) == 1
    resumed = _port(small_cohort, tmp_path / "c",
                    load_checkpoint=models + "/nm-epoch1-fold0")
    resumed.train_and_test()
    assert resumed.results.get_meter("loss", 0).values == \
        losses_run[per_epoch:]
    assert resumed.results.get_meter("test_loss", 0).values == \
        first.results.get_meter("test_loss", 0).values[-len(
            resumed.results.get_meter("test_loss", 0).values):]
    for k, v in first.final_state.model.state_dict().items():
        assert torch.equal(resumed.final_state.model.state_dict()[k], v), k


def test_nested_trainer_records_each_real_window(small_cohort, tmp_path):
    """One prediction per real window of each test patient (the pad
    windows dropped), the losses one per patient, and the train set's
    oversampled windows kept in their patients' super batches."""
    trainer = _port(small_cohort, tmp_path, epochs=1)
    trainer.train_and_test()
    train_ds, test_ds = trainer.get_base_datasets()
    train_ds.set_kfold_indexes_for_fold(0)
    test_ds.set_kfold_indexes_for_fold(0)
    groups = patient_groups(test_ds)
    assert len(trainer.results.get_meter("test_loss", 0)) == len(groups)
    assert len(trainer.results.get_meter("loss", 0)) == len(
        patient_groups(train_ds))
    assert sorted(trainer.last_eval["index"].tolist()) == sorted(
        test_ds.current_indices().tolist())
    assert trainer.last_eval["logits"].shape == (
        len(test_ds.current_indices()), 2)
    assert sum(len(i) for _, i, _ in patient_groups(train_ds)) == len(
        train_ds.current_indices())


def test_parallel_folds_with_a_nested_network(small_cohort, tmp_path):
    """The JAX package sends a nested network with ``parallel_folds`` to
    its ParallelFoldTrainer, which feeds it batches of windows as if each
    were a patient and fails recording the eval (a reshape of (W, 2)
    logits to (W, S, 2)); the port refuses the case by name."""
    over = _overrides(small_cohort, tmp_path, parallel_folds=True,
                      only_fold=None, epochs=1)
    with pytest.raises(ValueError, match="cannot reshape"):
        jax_make_trainer(JaxConfiguration(overrides=over),
                         verbose=False).train_and_test()
    with pytest.raises(ValueError, match="cnn_to_nested_lstm.*super batch"):
        make_trainer(Configuration(overrides=over), device="cpu",
                     verbose=False).train_and_test()


def test_nested_steps_restore_through_functools_partial():
    """The whole-run tests set the transformer's dropout to 0 through
    ``functools.partial`` on both sides; the port's network builds its
    transformer from the module's name, so the partial takes effect."""
    orig = nested.Transformer
    try:
        nested.Transformer = functools.partial(orig, dropout=0.0)
        model = nested.CNNToNestedTransformerNetwork(
            resnet1d.resnet18(initial_planes=PLANES))
    finally:
        nested.Transformer = orig
    assert all(b.dropout == 0.0 for b in model.transformer.blocks)
