"""The DTW heterogeneity library of the port against the JAX package.

KMedoids, ``dtw_full``, the inter-patient matrix, the cohort pickers, the
medoid clusters, the undersampler's score map and the cached per-patient
analysis: the same inputs through ``deepards_tpu`` and
``deepards_tpu_torch`` (on the CPU, where ``dtw_batch`` runs the kernel's
plain version ``dtw_reference``).  Medoids, labels, picked patients and
orders are equal; values equal, or within rtol 1e-6 where DTW distances
enter (the JAX package's scan and ``dtw_reference`` agree to that).
"""
import numpy as np
import pandas as pd
import pytest
import torch

from deepards_tpu.data.dataset import ARDSRawDataset as JaxDataset
from deepards_tpu.data.sampling import \
    undersample_by_homogeneity as jax_undersample
from deepards_tpu.dtw import lib as jlib
from deepards_tpu.dtw.kmedoids import KMedoids as JaxKMedoids
from deepards_tpu.ops.dtw import dtw_full as jax_dtw_full
from deepards_tpu_torch.data.dataset import ARDSRawDataset, GroundTruth
from deepards_tpu_torch.data.sampling import undersample_by_homogeneity
from deepards_tpu_torch.dtw import lib
from deepards_tpu_torch.dtw.kmedoids import KMedoids
from deepards_tpu_torch.ops.dtw import dtw_full

# parallel test workers share the cores: one torch thread each
torch.set_num_threads(1)

CLOSE = dict(rtol=1e-6, atol=0)


def _points(rng, n):
    pts = rng.normal(size=(n, 3))
    return np.sqrt(((pts[:, None] - pts[None]) ** 2).sum(-1))


@pytest.mark.parametrize("init", ["heuristic", "random", "k-medoids++"])
def test_kmedoids_matches_jax(init):
    rng = np.random.default_rng(42)
    for n, k in [(20, 2), (30, 4), (50, 8)]:
        D = _points(rng, n)
        for seed in (0, 5):
            ours = KMedoids(k, metric="precomputed", init=init,
                            random_state=seed).fit(D)
            theirs = JaxKMedoids(k, metric="precomputed", init=init,
                                 random_state=seed).fit(D)
            np.testing.assert_array_equal(ours.medoid_indices_,
                                          theirs.medoid_indices_)
            np.testing.assert_array_equal(ours.labels_, theirs.labels_)
            assert ours.inertia_ == theirs.inertia_
            np.testing.assert_array_equal(ours.predict(D), theirs.predict(D))
    # euclidean rows: distances computed inside
    X = rng.normal(size=(25, 2))
    np.testing.assert_array_equal(
        KMedoids(3, init=init).fit(X).predict(X),
        JaxKMedoids(3, init=init).fit(X).predict(X))


def test_kmedoids_duplicate_point_ties_match_jax():
    """Duplicated points tie at distance 0 and can pull a medoid out of
    its own cluster (kmedoids.py's members[0] rule)."""
    rng = np.random.default_rng(7)
    for _ in range(12):
        base = rng.normal(size=(12, 2))
        pts = np.repeat(base, rng.integers(2, 4, size=len(base)), axis=0)
        rng.shuffle(pts)
        D = np.sqrt(((pts[:, None] - pts[None]) ** 2).sum(-1))
        for k in (2, 3, 5):
            ours = KMedoids(k, metric="precomputed").fit(D)
            theirs = JaxKMedoids(k, metric="precomputed").fit(D)
            np.testing.assert_array_equal(ours.medoid_indices_,
                                          theirs.medoid_indices_)
            np.testing.assert_array_equal(ours.labels_, theirs.labels_)
            assert ours.inertia_ == theirs.inertia_
    with pytest.raises(ValueError, match="n_clusters"):
        KMedoids(5, metric="precomputed").fit(np.zeros((3, 3)))


@pytest.mark.parametrize("n,m,ties", [(37, 29, False), (1, 6, False),
                                      (9, 1, False), (24, 31, True)])
def test_dtw_full_matches_jax(n, m, ties):
    rng = np.random.default_rng(4 + n)
    if ties:  # small integers: equal costs along many paths
        a, b = rng.integers(0, 3, n), rng.integers(0, 3, m)
    else:
        a, b = rng.normal(size=n), rng.normal(size=m)
    d, cost, (px, py) = dtw_full(a, b)
    jd, jcost, (jpx, jpy) = jax_dtw_full(a, b)
    assert d == jd
    np.testing.assert_array_equal(cost, jcost)
    np.testing.assert_array_equal(px, jpx)
    np.testing.assert_array_equal(py, jpy)


# (n_sub_batches, kfold) views of the synthetic cohort: all 8 patients of
# the main holdout set, and fold 0's oversampled training patients (its
# current indices repeat windows)
VIEWS = {
    "holdout": dict(n_sub_batches=2),
    "fold_oversampled": dict(n_sub_batches=1, kfold_num=0, total_kfolds=2,
                             oversample_minority=True),
    "fold": dict(n_sub_batches=2, kfold_num=0, total_kfolds=2),
}


@pytest.fixture(scope="module")
def views(synthetic_cohort):
    built = {}
    for name, kw in VIEWS.items():
        args = (synthetic_cohort["data_path"], 1,
                synthetic_cohort["cohort_file"])
        kw = dict(kw, dataset_type="unpadded_centered_sequences")
        built[name] = (JaxDataset(*args, **kw), ARDSRawDataset(*args, **kw))
    return built


def _as_frame(mat):
    return pd.DataFrame(mat.values.copy(), index=list(mat.patients),
                        columns=list(mat.patients))


@pytest.mark.parametrize("view,method,n_random", [
    ("holdout", "random", 3),
    ("fold_oversampled", "random", 5),
    ("fold_oversampled", "same_ordered", 50),
])
def test_find_patient_similarity_matches_jax(views, view, method, n_random,
                                             tmp_path):
    jds, ds = views[view]
    want = jlib.find_patient_similarity(jds, dist_method=method,
                                        n_random=n_random)
    got = lib.find_patient_similarity(
        ds, dist_method=method, n_random=n_random, device="cpu",
        results_path=str(tmp_path / "mat.npz"))
    assert got.patients == [str(p) for p in want.index]
    assert got.values.dtype == np.float64
    np.testing.assert_allclose(got.values, want.values, **CLOSE)
    assert (got.values == got.values.T).all()
    assert (np.diag(got.values) == 0).all() and (got.values > 0).sum() == \
        len(got.patients) * (len(got.patients) - 1)
    with np.load(str(tmp_path / "mat.npz")) as saved:
        assert saved["patients"].tolist() == got.patients
        np.testing.assert_array_equal(saved["values"], got.values)


def test_find_patient_similarity_rejects_unknown_method(views):
    with pytest.raises(ValueError, match="dist_method"):
        lib.find_patient_similarity(views["holdout"][1], dist_method="x",
                                    device="cpu")


def test_sweep_timer_records_chunks_and_keeps_pairs():
    rng = np.random.default_rng(5)
    seqs_a = [rng.normal(size=30).astype(np.float32) for _ in range(9)]
    seqs_b = [rng.normal(size=30).astype(np.float32) for _ in range(9)]
    timer = lib.SweepTimer(keep=3)
    got = lib.batched_dtw_pairs(seqs_a, seqs_b, chunk=4, device="cpu",
                                timer=timer)
    np.testing.assert_array_equal(
        got, lib.batched_dtw_pairs(seqs_a, seqs_b, device="cpu"))
    assert len(timer.pad_s) == len(timer.copy_s) == 3
    assert timer.kernel_ms == []  # CUDA events only on a card
    a, b, la, lb, d = timer.kept
    assert a.shape == (3, 64) and (la == 30).all()
    np.testing.assert_array_equal(d.numpy(), got[:3].astype(np.float32))


class _Truth:
    """A stand-in dataset for the pickers: patients and classes only."""

    def __init__(self, patients, y):
        self.patients = np.asarray(patients)
        self.y = np.asarray(y)
        self.index = np.arange(len(patients))[::-1].copy()

    def get_ground_truth_df(self):
        return pd.DataFrame({"patient": self.patients, "y": self.y,
                             "hour": 0.0}, index=self.index)

    def get_ground_truth(self):
        return GroundTruth(self.index, self.patients, self.y,
                           np.zeros(len(self.y)))


def _tied_cohort(n_patients, seed):
    """A symmetric matrix of multiples of 250 (ties in the sorts and the
    argmax, balls of 1000 that grow in steps) over patients with two
    windows each, named so that string order is not numeric order."""
    rng = np.random.default_rng(seed)
    pts = ["{}".format(i * 7 % 101) for i in range(1, n_patients + 1)]
    values = rng.integers(1, 12, size=(n_patients, n_patients)) * 250.0
    values = np.triu(values, 1)
    values += values.T
    truth = _Truth([p for p in pts for _ in range(2)],
                   [i % 2 for i in range(n_patients) for _ in range(2)])
    return lib.PatientDistances(pts, values), truth


@pytest.fixture(scope="module")
def picker_inputs(views):
    """(label, PatientDistances, JAX dataset, port dataset): the cohort's
    DTW matrix, a random one over its patients, and two tied ones."""
    jds, ds = views["holdout"]
    out = [("similarity", lib.find_patient_similarity(
        ds, dist_method="random", n_random=3, device="cpu"), jds, ds)]
    rng = np.random.default_rng(3)
    pts = [str(p) for p in jds.get_ground_truth_df().sort_index()
           .patient.unique()]
    values = rng.uniform(100, 5000, size=(len(pts), len(pts)))
    values = np.triu(values, 1)
    values += values.T
    out.append(("cohort", lib.PatientDistances(pts, values), jds, ds))
    for n, seed in ((8, 0), (40, 1)):
        mat, truth = _tied_cohort(n, seed)
        out.append(("tied{}".format(n), mat, truth, truth))
    return out


@pytest.mark.parametrize("n_pts,exclude,retrieve_n,thresh", [
    (4, None, 1, 0.8), (4, None, 3, 0.9), (3, 2, 2, 1.0), (6, 1, 4, 0.7)])
def test_pickers_match_jax(picker_inputs, n_pts, exclude, retrieve_n,
                           thresh):
    for label, mat, jds, ds in picker_inputs:
        ex = mat.patients[:exclude] if exclude else None
        kw = dict(exclude=ex, retrieve_n=retrieve_n,
                  mean_similarity_thresh=thresh)
        for pick, jpick in ((lib.pick_similar_pts, jlib.pick_similar_pts),
                            (lib.pick_dissimilar_pts,
                             jlib.pick_dissimilar_pts)):
            got = pick(mat, ds, n_pts, **kw)
            want = jpick(_as_frame(mat), jds, n_pts, **kw)
            assert [list(map(str, w[1])) for w in want] == \
                [list(g[1]) for g in got], (label, pick.__name__)
            assert [float(w[0]) for w in want] == [g[0] for g in got]
            assert got, (label, pick.__name__)


def test_similar_picker_rejects_bad_arguments():
    mat, truth = _tied_cohort(8, 0)
    with pytest.raises(ValueError, match="retrieve_n"):
        lib.pick_similar_pts(mat, truth, 4, retrieve_n=0)
    with pytest.raises(ValueError, match="mean_similarity_thresh"):
        lib.pick_similar_pts(mat, truth, 4, mean_similarity_thresh=0)


def test_mediod_process_matches_jax(picker_inputs):
    """On matrices that list patients sorted by id, as an ETL cohort's
    does (see the next test for the others)."""
    for label, mat, jds, ds in picker_inputs:
        mat = mat.subset(sorted(mat.patients))
        for k in (2, 3):
            got = lib.mediod_process(mat, k, ds)
            want = jlib.mediod_process(_as_frame(mat), k, jds)
            assert got.patient == [str(p) for p in want.index], label
            np.testing.assert_array_equal(got.y, want.y.to_numpy())
            np.testing.assert_array_equal(got.clust, want.clust.to_numpy())


def test_mediod_process_assigns_clusters_by_patient():
    """The JAX package assigns the clusters by position to patients sorted
    by id, so they land on other patients when the matrix lists patients
    in another order; the port assigns each patient its own row's."""
    mat, truth = _tied_cohort(8, 2)
    assert mat.patients != sorted(mat.patients)
    got = lib.mediod_process(mat, 3, truth)
    own = KMedoids(3, metric="precomputed").fit(mat.values).predict(
        mat.values)
    by_patient = dict(zip(mat.patients, own.tolist()))
    assert got.clust.tolist() == [by_patient[p] for p in got.patient]
    want = jlib.mediod_process(_as_frame(mat), 3, truth)
    assert want.clust.tolist() == own.tolist()  # positional


def test_patient_score_map_and_undersampling_match_jax(views, tmp_path):
    jds, ds = views["fold"]
    want = jlib.build_patient_score_map(jds)
    got = lib.build_patient_score_map(ds, cache_dir=str(tmp_path),
                                      device="cpu")
    assert sorted(got) == sorted(want) and got
    np.testing.assert_allclose([got[k] for k in sorted(got)],
                               [want[k] for k in sorted(want)], **CLOSE)
    with open(tmp_path / "patient_score_map.json") as f:
        import json

        assert {int(k): v for k, v in json.load(f).items()} == got
    # the indices the undersampler keeps from the JAX package's own map
    for d, scores in ((jds, want), (ds, want)):
        d.dtw_scores = scores
        d.undersample_factor = 0.5
        d.undersample_std_factor = 1.0
        d.set_kfold_indexes_for_fold(0)
    before = len(jds.get_kfold_indexes_for_fold(0))
    assert len(ds.current_indices()) < before
    np.testing.assert_array_equal(ds.current_indices(),
                                  jds.current_indices())


def test_jax_undersample_factor_never_undersamples(synthetic_cohort):
    """Pins a fault of the JAX package: ``--undersample-factor`` reaches
    ``undersample_by_homogeneity`` with ``dtw_scores`` always {}
    (deepards_tpu/data/dataset.py:164,647,718: nothing loads a score map),
    so no window is a candidate and none is dropped.  The port keeps this
    behaviour."""
    args = (synthetic_cohort["data_path"], 1, synthetic_cohort["cohort_file"])
    kw = dict(n_sub_batches=2, dataset_type="unpadded_centered_sequences",
              kfold_num=0, total_kfolds=2)
    plain = JaxDataset(*args, **kw)
    asked = JaxDataset(*args, undersample_factor=0.5,
                       undersample_std_factor=1.0, **kw)
    assert asked.dtw_scores == {}
    np.testing.assert_array_equal(asked.current_indices(),
                                  plain.current_indices())
    port = ARDSRawDataset(*args, undersample_factor=0.5,
                          undersample_std_factor=1.0, **kw)
    assert port.dtw_scores == {}
    np.testing.assert_array_equal(port.current_indices(),
                                  plain.current_indices())


def test_undersampler_takes_one_median_over_all_windows():
    """Pins a fault of the JAX package: ``undersample_by_homogeneity``
    (deepards_tpu/data/sampling.py:131-154) takes the median and std over
    every window, not per patient as its docstring says.  Two patients on
    scales 1-10 and 101-110: per patient, each has windows near its
    median; over all windows (median 55.5, std 50), none is within 0.2
    std, so nothing is dropped.  The port does the same."""
    indices = np.arange(20)
    scores = {i: float(i + 1 if i < 10 else i + 91) for i in range(20)}
    for fn in (jax_undersample, undersample_by_homogeneity):
        kept = fn(indices, scores, 1.0, 0.2, np.random.default_rng(0))
        np.testing.assert_array_equal(kept, indices)


def _pred_rows(ds, patient, rng):
    """Prediction rows of a patient: some windows twice, hours jittered."""
    gt = ds.get_ground_truth()
    idx = gt.index[gt.patient == patient]
    rows = []
    for i in list(idx) + list(idx[::3]):
        rows.append({"index": int(i), "pred": int(rng.integers(0, 2)),
                     "hour": float(ds.cache.hours[i, 0] + rng.uniform(0, 1)),
                     "patient": patient, "y": 0})
    return rows


def test_analyze_patient_matches_jax_and_caches(views, tmp_path,
                                                monkeypatch):
    jds, ds = views["holdout"]
    pt = ds.get_ground_truth().patient[0]
    rows = _pred_rows(ds, pt, np.random.default_rng(1))
    preds = pd.DataFrame(rows).set_index("index")
    cases = [(None, None, 1), (lib.as_columns(rows), preds, 2)]
    for k, (port_preds, jax_preds, rolling) in enumerate(cases):
        got = lib.analyze_patient(pt, ds, str(tmp_path / "port{}".format(k)),
                                  port_preds, rolling_len=rolling,
                                  device="cpu")
        want = jlib.analyze_patient(pt, jds,
                                    str(tmp_path / "jax{}".format(k)),
                                    jax_preds, rolling_len=rolling)
        np.testing.assert_array_equal(got.index, want.index.to_numpy())
        np.testing.assert_allclose(got.dtw, want.dtw.to_numpy(), **CLOSE)
        np.testing.assert_array_equal(got.hour, want.hour.to_numpy())
        assert np.isnan(got.dtw[:3]).all() and len(got.index) == \
            2 * (ds.get_ground_truth().patient == pt).sum()
        name = "{}_n3_rolling{}_unpadded_centered_sequences_nb2_holdout"\
            .format(pt, rolling)
        assert (tmp_path / "port{}".format(k) / pt / (name + ".npz")).exists()
        assert (tmp_path / "jax{}".format(k) / pt / (name + ".pkl")).exists()

        def no_dtw(*args, **kw):
            raise AssertionError("a cached patient ran the DTW")

        monkeypatch.setattr(lib, "batched_dtw_pairs", no_dtw)
        again = lib.analyze_patient(pt, ds, str(tmp_path / "port{}".format(
            k)), port_preds, rolling_len=rolling, device="cpu")
        monkeypatch.undo()
        for field in ("index", "dtw", "hour"):
            np.testing.assert_array_equal(getattr(again, field),
                                          getattr(got, field))
