"""Cam analytics and the explainer comparison on the CPU against the JAX
package.

The numpy silhouette within 1e-10 of scikit-learn's (and its refusals);
``kmean_clust_search``, ``pca_2d``, ``cluster_prototypes`` and
``frequency_band_analytics`` within 1e-10 of the JAX package's on the same
cams; ``collect_cams`` and ``ExplainerComparison.compare`` (cnn_linear /
densenet18 and PPNet, numpy-drawn params carried over with ``transplant``,
on the seeded cohort of ``test_torch_patient_gradcam.py``) within 1e-5 of
max(1, |x|) with the same columns, rows and NaN cells; the JAX package's
``collect_cams`` failing on a train view whose oversampler repeats
windows, pinned.
"""
from types import SimpleNamespace

import numpy as np
import pandas as pd
import pytest
import sklearn.metrics
import torch
from test_torch_patient_gradcam import (
    PATHO,
    PATIENTS,
    close,
    cnn_linear,
    save_cohort,
)
from test_torch_prototypes import ppnets

from deepards_tpu.data.dataset import ARDSRawDataset as JaxDataset
from deepards_tpu.explain import cam_analytics as jcam_analytics
from deepards_tpu.explain import explainer_comparison as jcomparison
from deepards_tpu.explain import gradcam as jgradcam
from deepards_tpu.explain import prototypes as jprototypes
from deepards_tpu_torch.data.dataset import ARDSRawDataset
from deepards_tpu_torch.explain import cam_analytics, explainer_comparison
from deepards_tpu_torch.explain import gradcam, prototypes

# parallel test workers share the cores: one torch thread each
torch.set_num_threads(1)

EXACT = dict(rtol=1e-10, atol=1e-10)


def _cam_rows(seed, n=30, width=7):
    """uint8-valued cam rows in a few loose groups."""
    rng = np.random.default_rng(seed)
    centers = rng.integers(0, 256, size=(3, width))
    rows = centers[rng.integers(0, 3, size=n)] + rng.normal(
        scale=20, size=(n, width))
    return np.clip(np.round(rows), 0, 255)


@pytest.mark.parametrize("seed,k", [(0, 2), (1, 3), (2, 5), (3, 9)])
def test_silhouette_matches_sklearn(seed, k):
    X = _cam_rows(seed)
    labels = cam_analytics._kmeans(X, k, seed=seed)
    np.testing.assert_allclose(
        cam_analytics.silhouette_score(X, labels),
        sklearn.metrics.silhouette_score(X, labels), **EXACT)


def test_silhouette_refuses_what_sklearn_refuses():
    X = _cam_rows(4, n=5)
    for labels in ([0] * 5, [0, 1, 2, 3, 4]):
        with pytest.raises(ValueError):
            sklearn.metrics.silhouette_score(X, labels)
        with pytest.raises(ValueError, match="Number of labels"):
            cam_analytics.silhouette_score(X, labels)
    # a cluster of one counts 0, as in scikit-learn
    labels = [0, 0, 1, 1, 2]
    np.testing.assert_allclose(
        cam_analytics.silhouette_score(X, labels),
        sklearn.metrics.silhouette_score(X, labels), **EXACT)


@pytest.mark.parametrize("seed,max_clusts", [(0, 5), (5, 8)])
def test_kmean_clust_search_and_pca_match_jax(seed, max_clusts):
    X = _cam_rows(seed)
    got = cam_analytics.kmean_clust_search(X, max_clusts=max_clusts)
    want = jcam_analytics.kmean_clust_search(X, max_clusts=max_clusts)
    for a, b in zip(got[:3], want[:3]):
        np.testing.assert_allclose(a, b, **EXACT)
    assert got[3] == want[3]
    assert list(got[4]) == list(want[4].columns)
    assert got[4]["clusterCount"] == want[4].clusterCount.tolist()
    np.testing.assert_allclose(got[4]["gap"], want[4].gap, **EXACT)
    np.testing.assert_allclose(cam_analytics.pca_2d(X),
                               jcam_analytics.pca_2d(X), **EXACT)


def test_frequency_band_analytics_matches_jax():
    rng = np.random.default_rng(6)
    cams = {0: rng.uniform(0, 255, size=(9, 7)), 1: np.zeros((0, 7)),
            "ards": rng.uniform(0, 255, size=(4, 224))}
    got = cam_analytics.frequency_band_analytics(cams)
    want = jcam_analytics.frequency_band_analytics(cams)
    assert list(got) == list(want.columns)
    assert got["patho"] == want.patho.tolist()
    for band in cam_analytics.BANDS:
        np.testing.assert_allclose(got[band], want[band], **EXACT)


@pytest.fixture(scope="module")
def cohort(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("cam_analytics"))
    path = save_cohort(root, total_kfolds=2, n_windows=3)
    views = {}
    for name, package in (("port", ARDSRawDataset), ("jax", JaxDataset)):
        ds = package.from_pickle(path)
        views[name] = package.make_test_dataset_if_kfold(ds)
        views[name].set_kfold_indexes_for_fold(0)
    jmodel, params, model = cnn_linear()
    return {"path": path, "views": views,
            "cams": (gradcam.MaxMinNormCam(model),
                     jgradcam.MaxMinNormCam(jmodel, params))}


def test_collect_cams_and_cluster_prototypes_match_jax(cohort):
    cam, jcam = cohort["cams"]
    ds, jds = cohort["views"]["port"], cohort["views"]["jax"]
    X, seq_map, pathos = cam_analytics.collect_cams(cam, ds, max_windows=5)
    jX, jseq_map, jpathos = jcam_analytics.collect_cams(jcam, jds,
                                                        max_windows=5)
    close(X, jX)
    assert seq_map == jseq_map
    np.testing.assert_array_equal(pathos, jpathos)
    assert pathos.dtype == jpathos.dtype
    got = cam_analytics.cluster_prototypes(jX, 2, ds, jseq_map)
    want = jcam_analytics.cluster_prototypes(jX, 2, jds, jseq_map)
    for a, b in zip(got, want):
        assert {k: v for k, v in a.items() if k != "sequence"} == \
            {k: v for k, v in b.items() if k != "sequence"}
        np.testing.assert_array_equal(a["sequence"], b["sequence"])


def test_collect_cams_reads_oversampled_windows(cohort, tmp_path):
    """A train view whose oversampler repeats windows (2 ARDS patients of
    6): the port reads each row's class by position; the JAX package's
    ``gt.loc[idx]`` finds every row of a repeated index and fails
    (``deepards_tpu/explain/cam_analytics.py:141``)."""
    cam, jcam = cohort["cams"]
    path = save_cohort(str(tmp_path), total_kfolds=2,
                       patients=PATIENTS + ["9", "6"],
                       patho=[0, 1, 1, 0, 0, 0], n_windows=2)
    views = {}
    for name, package in (("port", ARDSRawDataset), ("jax", JaxDataset)):
        views[name] = package.from_pickle(path, oversample_minority=True)
        views[name].set_kfold_indexes_for_fold(0)
    idx = views["port"].current_indices()
    assert len(set(idx.tolist())) < len(idx)
    np.testing.assert_array_equal(idx, views["jax"].current_indices())
    X, seq_map, pathos = cam_analytics.collect_cams(cam, views["port"])
    assert seq_map == idx.tolist() and len(X) == len(idx)
    np.testing.assert_array_equal(
        pathos, views["port"].cache.target[idx].argmax(axis=1))
    with pytest.raises(TypeError):
        jcam_analytics.collect_cams(jcam, views["jax"])


def _assert_frames_equal(got, want):
    assert list(got) == list(want.columns)
    for c in want.columns:
        a, b = np.asarray(got[c]), want[c].to_numpy()
        assert len(a) == len(b)
        if b.dtype.kind in "fi":
            a = a.astype(np.float64)
            nan = np.isnan(b.astype(np.float64))
            np.testing.assert_array_equal(np.isnan(a), nan)
            close(a[~nan], b[~nan].astype(np.float64))
        else:
            assert a.tolist() == b.tolist()


def test_explainer_comparison_matches_jax(cohort):
    """The correctly classified patients, cam and prototype summaries,
    their merge and the top feature; the merge of a cam summary of 2 of 3
    windows with the prototype summary (a row of one side only) against
    pandas' outer merge."""
    cam, jcam = cohort["cams"]
    ds, jds = cohort["views"]["port"], cohort["views"]["jax"]
    jmodel, params, model = ppnets()
    frame = prototypes.prototype_activation_frame(model, ds, 4)
    jframe = jprototypes.prototype_activation_frame(jmodel, params, jds, 4)
    # the view's patients right in the last epoch, wrong in the first;
    # a patient outside the view wrong in the last
    pts = ds.get_ground_truth().patients()
    patho = dict(zip(PATIENTS, PATHO))
    outside = next(p for p in PATIENTS if p not in pts)
    rows = [{"patient": p, "patho": patho[p], "epoch_num": e,
             "prediction": patho[p] if e else 1 - patho[p]}
            for e in (0, 1) for p in pts + [outside]]
    rows[-1]["prediction"] = 1 - patho[outside]
    results = SimpleNamespace(results=rows)
    jresults = SimpleNamespace(results=pd.DataFrame(rows))
    comparison = explainer_comparison.ExplainerComparison(ds, results)
    jcomp = jcomparison.ExplainerComparison(jds, jresults)
    assert comparison.correctly_classified_patients() == \
        jcomp.correctly_classified_patients() == pts

    rf = {"peep": 0.1, "tve": 0.7, "rr": 0.2}
    for gen, jgen in ((cam, jcam), (None, None)):
        got = comparison.compare(gen, frame, rf)
        want = jcomp.compare(jgen, jframe, rf)
        _assert_frames_equal(got, want)
    pt = pts[0]
    got = comparison.gradcam_summary(cam, pt, max_windows=2)
    want = jcomp.gradcam_summary(jcam, pt, max_windows=2)
    _assert_frames_equal(got, want)
    got = explainer_comparison._outer_merge(
        {**got, "patient": [pt] * 2},
        {**comparison.protopnet_summary(frame, pt), "patient": [pt] * 3})
    want = want.assign(patient=pt).merge(
        jcomp.protopnet_summary(jframe, pt).assign(patient=pt),
        on=["window_index", "patient"], how="outer", suffixes=("", "_pp"))
    _assert_frames_equal(got, want)
    assert np.isnan(got["cam_mean"]).sum() == 1


def test_comparison_of_a_patient_outside_the_dataset(cohort):
    """A correctly classified patient with no window in the dataset: the
    port's summaries are empty and the other patients' rows stand; the JAX
    package's empty cam frame has no ``window_index`` to merge on and
    raises (``deepards_tpu/explain/explainer_comparison.py:36-48,77``)."""
    cam, jcam = cohort["cams"]
    ds, jds = cohort["views"]["port"], cohort["views"]["jax"]
    pts = ds.get_ground_truth().patients()
    outside = next(p for p in PATIENTS if p not in pts)
    patho = dict(zip(PATIENTS, PATHO))
    rows = [{"patient": p, "patho": patho[p], "prediction": patho[p],
             "epoch_num": 0} for p in [outside] + pts]
    frame = {"window_index": ds.get_ground_truth().index,
             "prediction": np.zeros(len(ds.get_ground_truth().index), int),
             "proto_0": np.arange(len(ds.get_ground_truth().index), 0, -1.0)}
    got = explainer_comparison.ExplainerComparison(
        ds, SimpleNamespace(results=rows)).compare(cam, frame)
    assert set(got["patient"]) == set(pts)
    assert len(got["window_index"]) == len(frame["window_index"])
    with pytest.raises(KeyError, match="window_index"):
        jcomparison.ExplainerComparison(
            jds, SimpleNamespace(results=pd.DataFrame(rows))).compare(
                jcam, pd.DataFrame(frame))
