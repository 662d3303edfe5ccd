"""ProtoPNet's prototype analysis on the CPU against the JAX package.

PPNet over densenet18 at S = 3 with 2 prototypes a class of 128 channels
(numpy-drawn flax params, prototypes uniform in [0, 1), carried over with
``transplant``; dropout off, float32), on fold 0 of the seeded cohort of
``test_torch_patient_gradcam.py`` in chunks of 3 windows (the last one
short: the norms use each chunk's statistics, so the chunks are the JAX
package's).  Features, probabilities, activation columns and SHAP values
within 1e-5 of max(1, |x|); feature names, the top-k triple, the pane's
``.txt`` record, ``_rf_span_for`` and ``viz_prototypes``' outputs and
dumps equal; with and without ``average_linear``.  The flax module's
``apply`` runs under ``jax.jit`` (``jit_apply_in_place``): the JAX
package applies it eagerly here, which compiles every op anew for each
batch shape and would take most of a minute on the CPU.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_configs_2_3_4 import random_params
from test_torch_patient_gradcam import (
    assert_same_files,
    close,
    save_cohort,
)

from deepards_tpu.data.dataset import ARDSRawDataset as JaxDataset
from deepards_tpu.explain import prototypes as jprototypes
from deepards_tpu.models import densenet1d as jdensenet
from deepards_tpu.models import protopnet1d as jprotopnet
from deepards_tpu_torch.data.dataset import ARDSRawDataset
from deepards_tpu_torch.explain import prototypes
from deepards_tpu_torch.models import densenet1d, protopnet1d
from deepards_tpu_torch.transplant import transplant
from deepards_tpu_torch.utils import figures

# parallel test workers share the cores: one torch thread each
torch.set_num_threads(1)

S, L = 3, 224
BATCH = 3


def jit_apply_in_place(module):
    """Replace ``module.apply`` by one jitted function a method (its
    ``metadata`` None, its rngs passed through): the same computation,
    compiled once a shape."""
    apply = module.apply
    jitted = {}

    def jit_apply(variables, x, metadata=None, deterministic=False,
                  rngs=None, method=None):
        assert metadata is None
        key = (getattr(method, "__name__", None), deterministic)
        if key not in jitted:
            fn = method and getattr(module, key[0])
            jitted[key] = jax.jit(lambda v, x, r: apply(
                v, x, None, deterministic, rngs=r, method=fn))
        return jitted[key](variables, x, rngs)

    object.__setattr__(module, "apply", jit_apply)
    return module


def ppnets(average_linear=False, seed=1):
    """(flax PPNet, its numpy-drawn params, the port's PPNet holding
    them)."""
    jmodel = jprotopnet.construct_ppnet(
        jdensenet.densenet18(), sub_batch_size=S, n_prototypes=2,
        average_linear=average_linear)
    x = np.zeros((2, S, 1, L), np.float32)
    params = random_params(jmodel, seed, jnp.asarray(x), None, True)
    params["prototype_vectors"] = np.random.default_rng(seed).uniform(
        size=params["prototype_vectors"].shape).astype(np.float32)
    model = protopnet1d.construct_ppnet(
        densenet1d.densenet18(), sub_batch_size=S, n_prototypes=2,
        average_linear=average_linear)
    model.load_state_dict(transplant(params))
    return jit_apply_in_place(jmodel), params, model


def fold_views(path, package):
    train = package.from_pickle(path)
    train.set_kfold_indexes_for_fold(0)
    test = package.make_test_dataset_if_kfold(train)
    test.set_kfold_indexes_for_fold(0)
    return train, test


@pytest.fixture(scope="module")
def cohort(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("prototypes"))
    path = save_cohort(root, total_kfolds=2)
    return fold_views(path, ARDSRawDataset), fold_views(path, JaxDataset)


@pytest.fixture(scope="module", params=[False, True],
                ids=["per_window", "average_linear"])
def analyses(request, cohort):
    (train, test), (jtrain, jtest) = cohort
    jmodel, params, model = ppnets(request.param)
    return (prototypes.ProtoPNetAnalysis(model, train, test, BATCH),
            jprototypes.ProtoPNetAnalysis(jmodel, params, jtrain, jtest,
                                          BATCH))


def test_features_and_probabilities_match_jax(analyses):
    got, want = analyses
    assert got.feature_names == want.feature_names
    np.testing.assert_array_equal(got.coefs, want.coefs)
    for split in ("train", "test"):
        features = getattr(want, split + "_features")
        close(getattr(got, split + "_features"), features.to_numpy())
        np.testing.assert_array_equal(getattr(got, split + "_gt").index,
                                      features.index.to_numpy())
        close(getattr(got, split + "_preds"), getattr(want, split + "_preds"))
    assert len(got.test_gt.index) % BATCH  # a short last chunk


def test_features_are_the_similarity_of_the_kept_distances(analyses):
    """``train_distances``/``test_distances`` are the windows' minimum
    distances, and the features their similarity as the head takes it."""
    got, _ = analyses
    model = got.model
    p, s = model.num_prototypes, got.test_ds.cache.data.shape[1]
    for split in ("train", "test"):
        dists = getattr(got, split + "_distances")
        assert dists.shape == (len(getattr(got, split + "_gt").index), s * p)
        with torch.no_grad():
            sims = model.distance_to_similarity(
                torch.from_numpy(dists)).numpy()
        if model.average_linear:
            sims = sims.reshape(len(dists), s, p).mean(axis=1)
        np.testing.assert_allclose(getattr(got, split + "_features"), sims,
                                   rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("gt,pred,topk,seed", [
    ("ards", "ards", 4, 5), ("non_ards", "non_ards", 2, 6),
    ("ards", "non_ards", 40, 7), ("non_ards", "ards", 1, 8)])
def test_topk_pick_matches_jax(analyses, gt, pred, topk, seed):
    got, want = analyses
    triple = got.plot_random_proto_from_linear_with_topk(
        gt, pred, topk, rng=np.random.default_rng(seed))
    assert triple == want.plot_random_proto_from_linear_with_topk(
        gt, pred, topk, rng=np.random.default_rng(seed))
    idx, breath_n, proto_n = triple
    window = got.test_pipe(got.test_ds.gather([idx])["data"])[0]
    assert got._rf_span_for(window, breath_n, proto_n) == \
        want._rf_span_for(window, breath_n, proto_n)


def test_random_sequence_pane_matches_jax(analyses, tmp_path, monkeypatch):
    got, want = analyses
    monkeypatch.setattr(jprototypes, "_get_plt", lambda: None)
    monkeypatch.setattr(figures, "refusal",
                        lambda device: "matplotlib is missing")
    base = got.make_random_sequence_pane(str(tmp_path / "port"),
                                         rng=np.random.default_rng(2))
    want.make_random_sequence_pane(str(tmp_path / "jax"),
                                   rng=np.random.default_rng(2))
    assert_same_files(str(tmp_path / "port"), str(tmp_path / "jax"))
    with open(base + ".txt") as f:
        assert len(f.read().splitlines()) == 17


@pytest.mark.parametrize("average_linear", [False, True])
def test_activation_frame_and_shap_match_jax(cohort, average_linear):
    (train, _), (jtrain, _) = cohort
    jmodel, params, model = ppnets(average_linear)
    frame = prototypes.prototype_activation_frame(model, train, BATCH)
    want = jprototypes.prototype_activation_frame(jmodel, params, jtrain,
                                                  BATCH)
    assert list(frame) == list(want.columns)
    for c in want.columns:
        close(frame[c], want[c].to_numpy())
        assert frame[c].dtype == want[c].dtype
    shap, base = prototypes.prototype_shap_values(model, train, BATCH)
    want_shap, want_base = jprototypes.prototype_shap_values(
        jmodel, params, jtrain, batch_size=BATCH)
    assert list(shap)[1:] == list(want_shap.columns)
    np.testing.assert_array_equal(shap["window_index"],
                                  want_shap.index.to_numpy())
    for c in want_shap.columns:
        close(shap[c], want_shap[c].to_numpy())
    close(base, want_base)


def test_viz_prototypes_matches_jax(cohort, tmp_path, monkeypatch):
    (train, _), (jtrain, _) = cohort
    jmodel, _, model = ppnets()
    monkeypatch.setattr(jprototypes, "_get_plt", lambda: None)
    monkeypatch.setattr(figures, "refusal",
                        lambda device: "matplotlib is missing")
    positions = model.proto_layer_rf_info()[0]
    push_info = [{"window_index": 0, "flat_pos": 3, "distance": 1.0}, None,
                 {"window_index": 9, "flat_pos": positions + 5,
                  "distance": 2.5},
                 {"window_index": 4, "flat_pos": 3 * positions - 1,
                  "distance": 0.0}]
    got = prototypes.PrototypeVisualizer(
        model, train, str(tmp_path / "port")).viz_prototypes(push_info, 2)
    want = jprototypes.PrototypeVisualizer(
        jmodel, jtrain, str(tmp_path / "jax")).viz_prototypes(push_info, 2)
    assert got == want and len(got) == 3
    assert_same_files(str(tmp_path / "port"), str(tmp_path / "jax"))
