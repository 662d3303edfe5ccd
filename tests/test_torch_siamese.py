"""The siamese networks, their triplets and their refusals against the JAX
package.

- the three twin networks and ``siamese_pretrained`` (each time layer),
  under both ``bn_scope``s, from numpy-drawn flax params carried over
  with ``transplant``: logits within 1e-4; the port's one call over
  anchor, positive and negative gives the JAX trainer's two calls;
- the dropout the JAX trainer's two calls share (one key) and its eval
  with dropout on, as the port's steps have them;
- the triplets: anchors, positives and every negative drawn equal to the
  JAX dataset's for the same seed, the init draws included;
- what is refused: folds (``kfolds``, ``bootstrap``; the JAX trainer
  fails on them with an AttributeError) and ``--load-siamese``."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_configs_2_3_4 import jit_apply, random_params, windows

import deepards_tpu.train.loop as jloop
import deepards_tpu_torch.train.loop as tloop
from deepards_tpu.config import Configuration as JaxConfiguration
from deepards_tpu.data.siamese_dataset import (
    SiameseWindowDataset as JaxSiameseDataset,
)
from deepards_tpu.models import densenet1d as jdensenet
from deepards_tpu.models import siamese as jsiamese
from deepards_tpu_torch.cli.predict import predict
from deepards_tpu_torch.cli.serve import InferenceEngine
from deepards_tpu_torch.cli.train import main as train_main
from deepards_tpu_torch.config.config import Configuration
from deepards_tpu_torch.data.siamese_dataset import SiameseWindowDataset
from deepards_tpu_torch.models import densenet1d, siamese
from deepards_tpu_torch.train.siamese_trainer import (
    SiameseTrainer,
    make_siamese_steps,
)
from deepards_tpu_torch.train.steps import TrainState, make_optimizer
from deepards_tpu_torch.transplant import transplant

# parallel test workers share the cores: one torch thread each
torch.set_num_threads(1)

B, S, L, HIDDEN = 3, 4, 224, 8
NARROW = dict(growth_rate=8, block_config=(1, 1, 1, 1), num_init_features=16)
TWINS = [("SiameseCNNLinearNetwork", {}),
         ("SiameseCNNLSTMNetwork", dict(hidden_units=HIDDEN)),
         ("SiameseCNNTransformerNetwork", dict(hidden_units=HIDDEN))]


def _t(x):
    return torch.from_numpy(np.asarray(x))


@pytest.mark.parametrize("scope", ["batch", "sequence"])
@pytest.mark.parametrize("name,options", TWINS)
def test_twin_networks_match_flax(name, options, scope):
    x, c, n = (windows(seed, (B, S, 1, L)) for seed in (0, 1, 2))
    jmodel = getattr(jsiamese, name)(
        breath_block=jdensenet.DenseNet1D(**NARROW), bn_scope=scope,
        **options)
    params = random_params(jmodel, 3, jnp.asarray(x), jnp.asarray(c), True)
    apply = jit_apply(jmodel, True)
    want_pos = apply(params, jnp.asarray(x), None, jnp.asarray(c))
    want_neg = apply(params, jnp.asarray(x), None, jnp.asarray(n))
    model = getattr(siamese, name)(densenet1d.DenseNet1D(**NARROW), S,
                                   bn_scope=scope, **options)
    model.load_state_dict(transplant(params))
    with torch.no_grad():
        pair = model(_t(x), _t(c), True)
        both = model(_t(x), _t(c), True, negative=_t(n))
    for got, want in ((pair, want_pos), (both[0], want_pos),
                      (both[1], want_neg)):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-4,
                                   rtol=0)


@pytest.mark.parametrize("time_layer", ["none", "lstm", "transformer"])
def test_siamese_pretrained_matches_flax(time_layer):
    x = windows(4, (B, S, 1, L))
    jmodel = jsiamese.SiameseARDSClassifier(
        breath_block=jdensenet.DenseNet1D(**NARROW), time_layer=time_layer,
        hidden_units=HIDDEN)
    params = random_params(jmodel, 5, jnp.asarray(x), None, True)
    want = jit_apply(jmodel, True)(params, jnp.asarray(x), None, None)
    model = siamese.SiameseARDSClassifier(
        densenet1d.DenseNet1D(**NARROW), S, time_layer, HIDDEN)
    model.load_state_dict(transplant(params))
    with torch.no_grad():
        got = model(_t(x), True)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-4,
                               rtol=0)
    with pytest.raises(ValueError, match="siamese_time_layer"):
        siamese.SiameseARDSClassifier(densenet1d.DenseNet1D(**NARROW), S,
                                      "gru")


def _transformer_twin():
    return siamese.SiameseCNNTransformerNetwork(
        densenet1d.densenet18(), S, HIDDEN).reset_parameters(
            torch.Generator().manual_seed(0))


def test_positive_and_negative_share_dropout_masks():
    """As the JAX trainer's two calls under one dropout key: a negative
    equal to the positive gives the positive's logits exactly, with
    dropout on in the backbone and the transformer; the anchor's tower
    draws masks of its own (a pair of equal windows compares unequal
    features)."""
    model = _transformer_twin()
    x, c = _t(windows(6, (B, S, 1, L))), _t(windows(7, (B, S, 1, L)))
    with torch.no_grad():
        both = model(x, c, False, torch.Generator().manual_seed(1),
                     negative=c)
        same = model(x, x, False, torch.Generator().manual_seed(1))
        still = model(x, x, True)
    assert torch.equal(both[0], both[1])
    assert not torch.allclose(same, still)


def test_eval_runs_with_dropout_on():
    """The eval step draws dropout from the fold's generator, as the JAX
    trainer's eval (which passes ``deterministic=False``): two evals from
    one state differ and advance the generator; with dropout off they are
    equal."""
    data = [_t(windows(seed, (B, S, 1, L))) for seed in (8, 9, 10)]
    for active in (True, False):
        model = _transformer_twin()
        state = TrainState(model, make_optimizer(model.parameters()),
                           torch.Generator().manual_seed(2))
        _, eval_step = make_siamese_steps(dropout_active=active)
        before = state.generator.get_state()
        first = eval_step(state, data[0], None, None, data[1], data[2])[1]
        second = eval_step(state, data[0], None, None, data[1], data[2])[1]
        assert first.shape == (2, B, 2)
        assert torch.equal(first, second) != active
        assert torch.equal(state.generator.get_state(), before) != active


@pytest.fixture(scope="module")
def triplet_sets(synthetic_cohort):
    """Both packages' train and test triplet datasets over the shared
    cohort's ``main`` holdout (seeds 42 and 43)."""
    args = (synthetic_cohort["data_path"], 1, 4)
    kw = dict(dataset_type="unpadded_centered_sequences",
              cohort_file=synthetic_cohort["cohort_file"])
    return {train: (JaxSiameseDataset(*args, train=train, seed=seed, **kw),
                    SiameseWindowDataset(*args, train=train, seed=seed, **kw))
            for train, seed in ((True, 42), (False, 43))}


@pytest.mark.parametrize("train", [True, False])
def test_triplets_equal_jax(triplet_sets, train):
    """The init's two draws, then an epoch's permuted anchors in batches
    (train) or the anchors in order (test): every index equal."""
    jax_ds, ds = triplet_sets[train]
    np.testing.assert_array_equal(ds.anchor_idx, jax_ds.anchor_idx)
    np.testing.assert_array_equal(ds.pos_idx, jax_ds.pos_idx)
    assert len(ds) > 8
    order = (np.random.default_rng(0).permutation(len(ds)) if train
             else np.arange(len(ds)))
    draws = [np.arange(2), order[:8], order[8:]]
    for rel in draws:
        got = ds.sample_triplet_indices(rel)
        want = jax_ds.sample_triplet_indices(rel)
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g, w)
        patient = ds.base.cache.patient_idx
        assert (patient[got[0]] == patient[got[1]]).all()
        assert (patient[got[0]] != patient[got[2]]).all()
    a, p, n = ds.sample_triplets(np.arange(3))
    assert a.shape == p.shape == n.shape == (3, 4, 1, L)


def test_from_pickle_equals_jax(triplet_sets, tmp_path):
    jax_ds, ds = triplet_sets[True]
    path = ds.base.save(str(tmp_path / "siamese.npz"))
    got = SiameseWindowDataset.from_pickle(path)
    want = JaxSiameseDataset.from_pickle(path)
    for g, w in zip(got.sample_triplet_indices(np.arange(10)),
                    want.sample_triplet_indices(np.arange(10))):
        np.testing.assert_array_equal(g, w)


def _overrides(cohort, tmp_path, **over):
    base = dict(
        data_path=cohort["data_path"], cohort_file=cohort["cohort_file"],
        experiment_num=1, network="siamese_cnn_linear",
        base_network="densenet18",
        dataset_type="unpadded_centered_sequences", n_sub_batches=4,
        kfolds=None, epochs=1, batch_size=8, compute_dtype="float32",
        results_dir=str(tmp_path / "results"), seed=7)
    base.update(over)
    return base


@pytest.mark.parametrize("option", ["kfolds", "bootstrap"])
def test_siamese_folds_refused(synthetic_cohort, tmp_path, option):
    """The port refuses folds by name; the JAX trainer takes them and
    fails at the first fold: its triplet dataset has no fold indexes."""
    over = {option: 2 if option == "kfolds" else True}
    with pytest.raises(ValueError, match=option):
        tloop.make_trainer(Configuration(overrides=_overrides(
            synthetic_cohort, tmp_path, **over)), device="cpu")
    if option == "kfolds":
        trainer = jloop.make_trainer(JaxConfiguration(overrides=_overrides(
            synthetic_cohort, tmp_path, **over)), verbose=False)
        with pytest.raises(AttributeError,
                           match="set_kfold_indexes_for_fold"):
            trainer.train_and_test()


@pytest.mark.parametrize("network", ["siamese_cnn_lstm", "siamese_pretrained",
                                     "cnn_linear"])
def test_load_siamese_refused(synthetic_cohort, tmp_path, network):
    """``--load-siamese`` is read by nothing in either package; the port
    refuses it by name and points at ``--load-base-network``."""
    with pytest.raises(ValueError, match="load-base-network"):
        train_main([
            "--network", network, "--data-path",
            synthetic_cohort["data_path"], "--cohort-file",
            synthetic_cohort["cohort_file"], "--load-siamese", "s.pt",
            "--device", "cpu"])


def test_parallel_folds_goes_to_the_siamese_trainer(synthetic_cohort,
                                                    tmp_path):
    """As in the JAX package, whose parallel-fold trainer takes networks of
    the standard trainer only."""
    conf = _overrides(synthetic_cohort, tmp_path, parallel_folds=True)
    assert type(tloop.make_trainer(Configuration(overrides=conf),
                                   device="cpu")) is SiameseTrainer
    jtrainer = jloop.make_trainer(JaxConfiguration(overrides=conf),
                                  verbose=False)
    assert type(jtrainer).__name__ == "SiameseTrainer"


@pytest.mark.parametrize("network,kind", [
    ("siamese_cnn_linear", "siamese"), ("siamese_cnn_transformer", "siamese"),
    ("autoencoder", "autoencoder")])
def test_predict_and_serve_refuse_what_is_not_a_classifier(
        synthetic_cohort, tmp_path, network, kind):
    """``cli.predict`` and ``cli.serve`` answer with class probabilities:
    the twin networks and the autoencoder are refused by name, before any
    checkpoint is read."""
    conf = Configuration(overrides=_overrides(
        synthetic_cohort, tmp_path, network=network,
        base_network="basic_cnn_ae"))
    with pytest.raises(ValueError, match=kind):
        predict(conf, str(tmp_path / "none.pt"), device="cpu")
    with pytest.raises(ValueError, match=kind):
        InferenceEngine(str(tmp_path / "none.pt"), network=network,
                        base_network="basic_cnn_ae", device="cpu")
