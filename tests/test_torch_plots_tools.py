"""The explain ops' PNGs, ``cli.dataset_figs`` and ``cli.dl_vs_rf`` on the
CPU against the JAX package, with matplotlib present on both sides.

What matplotlib is asked to draw is recorded on both sides
(``tests/torch_drawings.py``): the same PNG paths (uuids masked), the same
calls, arrays within 1e-5 of max(1, the array's largest magnitude) (cams and
filters in float32: the JAX package's float32 scan of a 10th-order 2 Hz
lowpass leaves float64 by 2.0e-4 on a flow of 43 l/min, the port's
product by 7.7e-5).

- ``PatientGradCam`` (the fixtures of ``test_torch_patient_gradcam.py``):
  ``medians`` and ``rand_sample`` (a PNG where the JAX package draws one,
  the ``.npz`` beside it as before), ``dtw_clust``'s elbows over the JAX
  package's spans and matrices, and ``plot_grads``;
- ``PrototypeVisualizer.viz_prototypes`` and the random prototype pane
  (the fixtures of ``test_torch_prototypes.py``), and
  ``viz_pca_clustering``;
- ``cli.dataset_figs`` on the seeded 4-patient cohort;
- ``cli.dl_vs_rf``: the forest's AUC, accuracy, patient rows and
  importances equal at the same seed, ``pt_diffs`` equal, the ROC curves
  drawn equal (``eval.metrics.roc_curve`` is scikit-learn's), and the
  forest refused by name without scikit-learn.
Each explain op's PNG stage is refused by name on the card and without
matplotlib, its ``.npz`` still written.
"""
import os
import sys

import numpy as np
import pandas as pd
import pytest
import torch
from test_torch_patient_gradcam import (  # noqa: F401 (fixtures)
    PATHO,
    PATIENTS,
    _run,
    pgcs,
    save_cohort,
    setup,
)
from test_torch_prototypes import analyses, cohort, ppnets  # noqa: F401
from torch_drawings import UUID, assert_same_drawings, record

from deepards_tpu.cli import dataset_figs as jfigs
from deepards_tpu.cli import dl_vs_rf as jrf
from deepards_tpu.data.dataset import ARDSRawDataset as JaxDataset
from deepards_tpu.explain import cam_analytics as jcam
from deepards_tpu.explain import prototypes as jprototypes
from deepards_tpu_torch.cli import dataset_figs, dl_vs_rf
from deepards_tpu_torch.data.dataset import ARDSRawDataset
from deepards_tpu_torch.explain import cam_analytics, prototypes
from deepards_tpu_torch.utils import figures

torch.set_num_threads(1)

RTOL = 1e-5


def _both(monkeypatch, tmp_path, jax_draw, port_draw):
    """(port drawings, JAX drawings), each under its own root."""
    out = {}
    for name, draw in (("jax", jax_draw), ("port", port_draw)):
        root = tmp_path / name
        os.makedirs(root, exist_ok=True)
        out[name] = record(monkeypatch, root)
        draw(str(root))
    return out["port"], out["jax"]


def _pngs_and_npz(root):
    names = [f for _, _, fs in os.walk(root) for f in fs]
    return ([f for f in names if f.endswith(".png")],
            [f for f in names if f.endswith(".npz")])


@pytest.mark.parametrize("op,panes", [("medians", None), ("rand_sample", 1)])
def test_patient_gradcam_pngs_match_jax(pgcs, tmp_path,  # noqa: F811
                                        monkeypatch, op,
                                        panes):
    jpgc, pgc = pgcs
    kwargs = {} if panes is None else dict(panes_per_group=panes)

    def draw(obj):
        def run(root):
            if panes is not None:
                kwargs["rng"] = np.random.default_rng(3)
            _run(obj, root, op, **kwargs)
        return run

    got, want = _both(monkeypatch, tmp_path, draw(jpgc), draw(pgc))
    assert len(want) == (len(PATIENTS) if op == "medians" else 2)
    assert_same_drawings(got, want, RTOL)
    # the port keeps the JAX package's matplotlib-less dumps beside them
    npz = [UUID.sub("<uuid>", os.path.relpath(os.path.join(base, f),
                                              tmp_path / "port"))
           for base, _, fs in os.walk(tmp_path / "port") for f in fs
           if f.endswith(".npz")]
    assert sorted(npz) == sorted(
        p[:-4] + ".npz" for p, figs in got.items() for _ in figs)


def test_dtw_clust_elbows_match_jax(pgcs, tmp_path, monkeypatch):  # noqa: F811
    """Over the JAX package's spans and matrices, so the elbows' clusters
    and distortions are the same numbers."""
    jpgc, pgc = pgcs
    spans, matrices = [], []
    orig_spans = jpgc._cam_active_spans
    orig_matrix = jpgc._pairwise_dtw_matrix

    def jax_spans(*args, **kw):
        spans.append(orig_spans(*args, **kw))
        return spans[-1]

    def jax_matrix(*args, **kw):
        matrices.append(orig_matrix(*args, **kw))
        return matrices[-1]
    monkeypatch.setattr(jpgc, "_cam_active_spans", jax_spans)
    monkeypatch.setattr(jpgc, "_pairwise_dtw_matrix", jax_matrix)
    given_spans, given = iter(spans), iter(matrices)
    monkeypatch.setattr(pgc, "_cam_active_spans",
                        lambda *a, **k: next(given_spans))
    monkeypatch.setattr(pgc, "_pairwise_dtw_matrix",
                        lambda *a, **k: next(given))
    got, want = _both(monkeypatch, tmp_path,
                      lambda root: _run(jpgc, root, "dtw_clust"),
                      lambda root: _run(pgc, root, "dtw_clust"))
    assert sorted(want) == sorted(
        "dtw_clustering/{}/{}/elbow.png".format(
            {0: "non_ards", 1: "ards"}[y], pt)
        for pt, y in zip(PATIENTS, PATHO))
    assert_same_drawings(got, want, RTOL)


def test_plot_grads_png_matches_jax(pgcs, tmp_path, monkeypatch):  # noqa: F811
    jpgc, pgc = pgcs
    for obj in (jpgc, pgc):
        obj.cam.grads.clear()
        obj.cam.preds.clear()
        _run(obj, str(tmp_path / str(id(obj))), "medians")
    got, want = _both(monkeypatch, tmp_path,
                      lambda root: jpgc.plot_grads(root + "/grads.png"),
                      lambda root: pgc.plot_grads(root + "/grads.png"))
    assert list(want) == ["grads.png"]
    assert_same_drawings(got, want, RTOL)


def test_prototype_pngs_match_jax(cohort, analyses, tmp_path,  # noqa: F811
                                  monkeypatch):
    (train, _), (jtrain, _) = cohort
    jmodel, _, model = ppnets()
    positions = model.proto_layer_rf_info()[0]
    push_info = [{"window_index": 0, "flat_pos": 3, "distance": 1.0}, None,
                 {"window_index": 9, "flat_pos": positions + 5,
                  "distance": 2.5}]
    got_pane, want_pane = analyses

    def jax_draw(root):
        jprototypes.PrototypeVisualizer(jmodel, jtrain, root).viz_prototypes(
            push_info, 2)
        want_pane.make_random_sequence_pane(root + "/pane",
                                            rng=np.random.default_rng(2))

    def port_draw(root):
        prototypes.PrototypeVisualizer(model, train, root).viz_prototypes(
            push_info, 2)
        got_pane.make_random_sequence_pane(root + "/pane",
                                           rng=np.random.default_rng(2))

    got, want = _both(monkeypatch, tmp_path, jax_draw, port_draw)
    assert sorted(want) == ["pane/sample-<uuid>.png", "proto-epoch2-p0.png",
                            "proto-epoch2-p2.png"]
    assert_same_drawings(got, want, RTOL)


def test_viz_pca_clustering_matches_jax(tmp_path, monkeypatch):
    x = np.random.default_rng(0).normal(size=(30, 12))
    got, want = _both(
        monkeypatch, tmp_path,
        lambda root: jcam.viz_pca_clustering(x, root + "/pca.png"),
        lambda root: cam_analytics.viz_pca_clustering(x, root + "/pca.png"))
    assert list(want) == ["pca.png"]
    assert_same_drawings(got, want, RTOL)
    with np.load(str(tmp_path / "port" / "pca.npz")) as z:
        assert sorted(z.files) == ["coords", "labels_k2", "labels_k3",
                                   "labels_k4", "labels_k5"]


@pytest.mark.parametrize("how", ["card", "no matplotlib"])
def test_explain_pngs_refused(pgcs, tmp_path, capsys,  # noqa: F811
                              monkeypatch, how):
    """The cams run on the CPU; the refusal reads the device "cuda"
    patched in, or finds matplotlib blocked."""
    _, pgc = pgcs
    if how == "card":
        monkeypatch.setattr(figures, "refusal", lambda device, _r=(
            figures.refusal): _r(torch.device("cuda")))
        reason = "drawn on the CPU host only"
    else:
        monkeypatch.setitem(sys.modules, "matplotlib", None)
        reason = "matplotlib is missing"
    _run(pgc, str(tmp_path), "medians")
    _run(pgc, str(tmp_path), "rand_sample", rng=np.random.default_rng(3),
         panes_per_group=1)
    x = np.random.default_rng(0).normal(size=(10, 4))
    cam_analytics.viz_pca_clustering(x, str(tmp_path / "p.png"))
    out = capsys.readouterr().out
    assert out.count("refused: " + reason) == len(PATIENTS) + 2 + 1
    assert "PNG stage p.png refused" in out
    pngs, npz = _pngs_and_npz(tmp_path)
    assert pngs == [] and len(npz) == len(PATIENTS) + 2 + 1


@pytest.fixture(scope="module")
def saved(tmp_path_factory):
    return save_cohort(str(tmp_path_factory.mktemp("figs")), total_kfolds=2)


def test_dataset_figs_match_jax(saved, tmp_path, monkeypatch):
    def view(cls):
        ds = cls.from_pickle(saved)
        ds.set_kfold_indexes_for_fold(0)
        return ds

    got, want = _both(
        monkeypatch, tmp_path,
        lambda root: jfigs.generate_all(view(JaxDataset), root),
        lambda root: dataset_figs.generate_all(view(ARDSRawDataset), root,
                                               device="cpu"))
    assert len(want) == 3 + 5 + 3 + 2
    assert_same_drawings(got, want, RTOL)
    with np.load(str(tmp_path / "port" / "butterworth-6hz.npz")) as z:
        assert z["raw"].shape == z["filtered"].shape == (224,)


def test_dataset_figs_cli_refuses_pngs_on_the_card(saved, tmp_path, capsys,
                                                   monkeypatch):
    monkeypatch.setitem(sys.modules, "matplotlib", None)
    assert dataset_figs.main(["--train-from-pickle", saved, "-o",
                              str(tmp_path), "--device", "cpu"]) == []
    out = capsys.readouterr().out
    assert out.count("refused: matplotlib is missing") == 13
    assert len([f for f in os.listdir(tmp_path) if f.endswith(".npz")]) == 13


def test_rf_matches_jax(saved):
    want = jrf.rf_patient_metrics(JaxDataset.from_pickle(saved), 0,
                                  n_estimators=20)
    got = dl_vs_rf.rf_patient_metrics(ARDSRawDataset.from_pickle(saved), 0,
                                      n_estimators=20)
    assert got["auc"] == want["auc"] or (np.isnan(got["auc"])
                                         and np.isnan(want["auc"]))
    assert got["accuracy"] == want["accuracy"]
    assert got["rows"] == want["frame"].to_dict(orient="records")
    assert got["importances"] == want["importances"]
    # both packages' features are all zero: without pressure every
    # breath's dynamic compliance is NaN, so every breath is dropped
    features = dl_vs_rf.window_bm_features(ARDSRawDataset.from_pickle(saved),
                                           range(4))
    np.testing.assert_array_equal(features, jrf.window_bm_features(
        JaxDataset.from_pickle(saved), range(4)))
    assert not features.any()


def test_rf_refused_without_sklearn(saved, monkeypatch):
    monkeypatch.setitem(sys.modules, "sklearn", None)
    monkeypatch.setitem(sys.modules, "sklearn.ensemble", None)
    with pytest.raises(ImportError, match="RandomForestClassifier"):
        dl_vs_rf.rf_patient_metrics(ARDSRawDataset.from_pickle(saved), 0)


def _patient_rows(seed, epochs=(1, 2)):
    rng = np.random.default_rng(seed)
    return [{"patient": str(p), "patho": p % 2,
             "prediction": int(rng.integers(0, 2)),
             "pred_frac": float(rng.uniform()), "epoch_num": e}
            for e in epochs for p in range(8)]


def test_pt_diffs_and_roc_match_jax(tmp_path, monkeypatch):
    runs = [_patient_rows(s) for s in (1, 2, 3)]
    rf = _patient_rows(4, epochs=(1,))
    want = jrf.pt_diffs([pd.DataFrame(r) for r in runs], pd.DataFrame(rf))
    got = dl_vs_rf.pt_diffs(runs, rf)
    assert got["improved_pts"] == want["improved_pts"] and got[
        "improved_pts"]
    assert got["regressed_pts"] == want["regressed_pts"]
    assert got["common_mispreds"] == want["common_mispreds"]
    assert got["dl_mispreds"] == want["dl_mispreds"].to_dict()
    assert got["rf_mispreds"] == want["rf_mispreds"].to_dict()
    for pt, row in got["improved_detail"].items():
        assert row["pred_frac"] == want["improved_detail"].loc[pt,
                                                               "pred_frac"]
    last = [r for r in runs[0] if r["epoch_num"] == 2]
    drawn, wanted = _both(
        monkeypatch, tmp_path,
        lambda root: jrf.plot_roc_curves(pd.DataFrame(last),
                                         pd.DataFrame(rf), root + "/roc.png"),
        lambda root: dl_vs_rf.plot_roc_curves(last, rf, root + "/roc.png"))
    assert list(wanted) == ["roc.png"]
    assert_same_drawings(drawn, wanted)


def test_fractional_training_curve_trains_through_the_trainer(
        synthetic_cohort, tmp_path):
    """A row a fraction: the last epoch's test AUC and patient accuracy of
    the port's trainer, meaned over its folds."""
    from deepards_tpu_torch.config.config import Configuration

    def conf(frac):
        return Configuration(overrides=dict(
            data_path=synthetic_cohort["data_path"],
            cohort_file=synthetic_cohort["cohort_file"], experiment_num=1,
            network="cnn_linear", base_network="densenet18",
            dataset_type="unpadded_centered_sequences", n_sub_batches=4,
            kfolds=2, only_fold=1, epochs=1, batch_size=8,
            compute_dtype="float32", train_pt_frac=frac,
            results_dir=str(tmp_path / str(frac)), seed=7))

    rows = dl_vs_rf.fractional_training_curve(conf, (0.5, 1.0),
                                              device="cpu")
    assert [r["train_pt_frac"] for r in rows] == [0.5, 1.0]
    for row in rows:
        assert 0.0 <= row["accuracy"] <= 1.0
        assert np.isnan(row["auc"]) or 0.0 <= row["auc"] <= 1.0
