"""Per-patient GradCAM on the CPU against the JAX package.

cnn_linear over densenet18 at S = 3 (numpy-drawn flax params carried over
with ``transplant``, float32), on a seeded cohort of 4 patients x 4
windows saved as the ``.npz`` both packages read; the JAX package writes
its ``.npz`` dumps (its ``_get_plt`` returns None here) and scores DTW
through its scan.  Each op writes the same files: arrays within 1e-5 of
max(1, |x|), records and scalars equal, ``cam_by_hour``'s pickles with the
same keys.  ``dtw_clust`` stage by stage: the raw cams within 1e-5 and
the uint8 cams equal but within float32 rounding of a step; the spans
equal on the same upsampled cams; the matrix within rtol 1e-6 on the same
spans; ``elbow.npz``'s clusters and span count equal and its distortions
within rtol 1e-6 from the same matrix; the whole op's spans equal, a
differing span explained by a cam value at its edge within rounding of a
uint8 step or of the threshold.
"""
import csv
import os
import pickle
import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_configs_2_3_4 import random_params
from test_torch_gradcam import _maxmin_scaled, _uint8_equal

import chip_smoke
from deepards_tpu.data.dataset import ARDSRawDataset as JaxDataset
from deepards_tpu.explain import gradcam as jgradcam
from deepards_tpu.explain import patient_gradcam as jpatient
from deepards_tpu.models import densenet1d as jdensenet
from deepards_tpu.models import heads as jheads
from deepards_tpu_torch.data.dataset import ARDSRawDataset
from deepards_tpu_torch.data.windowing import WindowCache
from deepards_tpu_torch.explain import gradcam
from deepards_tpu_torch.explain import patient_gradcam as patient
from deepards_tpu_torch.models import densenet1d, heads
from deepards_tpu_torch.transplant import transplant
from deepards_tpu_torch.utils import figures

# parallel test workers share the cores: one torch thread each
torch.set_num_threads(1)

S, L = 3, 224
# ids out of sorted order: the ops run patients in order of appearance
PATIENTS = ["7", "12", "3", "05"]
PATHO = [0, 1, 1, 0]
N_WINDOWS = 4
TOL = 1e-5  # of max(1, |x|)
UUID = re.compile(r"[0-9a-f]{8}-[0-9a-f]{4}-[0-9a-f]{4}-[0-9a-f]{4}-"
                  r"[0-9a-f]{12}")


def save_cohort(root, total_kfolds=None, patients=PATIENTS, patho=PATHO,
                n_windows=N_WINDOWS, seed=0):
    """A seeded cohort of flow-like windows (S, 1, 224), ``n_windows`` a
    patient at hours 0.5, 6.5, ..., saved as the ``.npz`` both packages
    read; returns its path."""
    rng = np.random.default_rng(seed)
    data = chip_smoke.make_windows(rng, len(patients) * n_windows, S)
    cohort = os.path.join(root, "cohort.csv")
    with open(cohort, "w", newline="") as f:
        writer = csv.writer(f)
        writer.writerow(["Patient Unique Identifier", "Pathophysiology"])
        writer.writerows([p, "ARDS" if y else "OTHER"]
                         for p, y in zip(patients, patho))
    hours = (np.arange(n_windows, dtype=np.float32) * 6 + 0.5)[:, None] \
        + np.arange(S, dtype=np.float32) * 0.01
    cache = WindowCache(
        data=data,
        target=np.eye(2, dtype=np.float32)[np.repeat(patho, n_windows)],
        hours=np.tile(hours, (len(patients), 1)),
        patient_idx=np.repeat(np.arange(len(patients)),
                              n_windows).astype(np.int32),
        patients=list(patients))
    return ARDSRawDataset(root, 1, cohort, S, "unpadded_centered_sequences",
                          cache=cache, total_kfolds=total_kfolds).save(
                              os.path.join(root, "cohort.npz"))


def cnn_linear(seed=2):
    """(flax cnn_linear/densenet18, its numpy-drawn params, the port's
    model holding them)."""
    jmodel = jheads.CNNLinearNetwork(breath_block=jdensenet.densenet18())
    x = np.zeros((2, S, 1, L), np.float32)
    params = random_params(jmodel, seed, jnp.asarray(x), None, True)
    model = heads.CNNLinearNetwork(densenet1d.densenet18(), S)
    model.load_state_dict(transplant(params))
    return jmodel, params, model


def close(got, want):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape
    if got.dtype.kind in "fc" or want.dtype.kind in "fc":
        limit = TOL * np.maximum(1.0, np.abs(want.astype(np.float64)))
        assert (np.abs(got.astype(np.float64) - want) <= limit).all(), \
            np.abs(got.astype(np.float64) - want).max()
    else:
        np.testing.assert_array_equal(got, want)


def tree(root):
    """{relative path with uuids masked: full path} of the files under
    ``root``."""
    out = {}
    for base, _, names in os.walk(root):
        for name in names:
            path = os.path.join(base, name)
            out.setdefault(UUID.sub("<uuid>", os.path.relpath(path, root)),
                           []).append(path)
    return out


def assert_same_files(got_root, want_root):
    """The same files, a pane's (uuid-named) files matched by its
    ``.txt`` record; ``.npz`` arrays and ``.pkl`` payloads close, text
    equal."""
    got, want = tree(got_root), tree(want_root)
    assert sorted(got) == sorted(want) and got
    for rel, paths in want.items():
        if len(paths) > 1:  # panes of one kind: match by record
            def by_record(ps):
                return {open(p[:-4] + ".txt").read(): p for p in ps}
            pairs = [(by_record(got[rel])[k], p)
                     for k, p in by_record(paths).items()]
            assert len(pairs) == len(paths)
        else:
            pairs = [(got[rel][0], paths[0])]
        for g, w in pairs:
            if w.endswith(".npz"):
                with np.load(g) as a, np.load(w) as b:
                    assert sorted(a.files) == sorted(b.files)
                    for k in b.files:
                        close(a[k], b[k])
            elif w.endswith(".pkl"):
                with open(g, "rb") as f:
                    a = pickle.load(f)
                with open(w, "rb") as f:
                    b = pickle.load(f)
                assert sorted(a) == sorted(b)
                for k in b:
                    if isinstance(b[k], np.ndarray):
                        close(a[k], b[k])
                    else:
                        assert a[k] == b[k] and type(a[k]) is type(b[k])
            else:
                assert open(g).read() == open(w).read()


@pytest.fixture(scope="module")
def setup(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("patient_gradcam"))
    path = save_cohort(root)
    jmodel, params, model = cnn_linear()
    return {"root": root, "port": ARDSRawDataset.from_pickle(path),
            "jax": JaxDataset.from_pickle(path), "jmodel": jmodel,
            "params": params, "model": model}


@pytest.fixture(scope="module")
def pgcs(setup):
    """One PatientGradCam of each package (the JAX one's cam functions
    compile once), both with recording cams."""
    jpgc = jpatient.PatientGradCam(
        setup["jmodel"], setup["params"], setup["jax"],
        cam_cls=lambda m, p: jgradcam.MaxMinNormCam(m, p, record_grads=True))
    pgc = patient.PatientGradCam(
        setup["model"], setup["port"],
        cam_cls=lambda m: gradcam.MaxMinNormCam(m, record_grads=True))
    return jpgc, pgc


@pytest.fixture(autouse=True)
def no_plots(monkeypatch):
    """Both packages write their .npz dumps, as on a host without
    matplotlib."""
    monkeypatch.setattr(jpatient, "_get_plt", lambda: None)
    monkeypatch.setattr(figures, "refusal",
                        lambda device: "matplotlib is missing")


def _run(pgc, results_dir, op, **kwargs):
    pgc.results_dir = results_dir
    return pgc.do_op(op, **kwargs)


def test_patients_and_truth_in_the_jax_frame_order(pgcs):
    jpgc, pgc = pgcs
    assert pgc.gt.patients() == list(
        jpgc.gt.patient.unique()) == PATIENTS
    np.testing.assert_array_equal(pgc.gt.index, jpgc.gt.index.to_numpy())
    assert pgc.gt.index.dtype == jpgc.gt.index.to_numpy().dtype
    np.testing.assert_array_equal(pgc.gt.y, jpgc.gt.y.to_numpy())
    np.testing.assert_array_equal(pgc.gt.hour, jpgc.gt.hour.to_numpy())


@pytest.mark.parametrize("target,want", [
    ("ground_truth", [1]), ("both", [0, 1]), ("ards", [1]), ("other", [0]),
    (0, [0])])
def test_get_target(pgcs, target, want):
    jpgc, pgc = pgcs
    pgc.target = jpgc.target = target
    try:
        assert pgc.get_target(1) == jpgc.get_target(1) == want
    finally:
        pgc.target = jpgc.target = "ground_truth"


@pytest.mark.parametrize("op,kwargs", [
    ("medians", {}), ("averages", {}),
    ("sample_seqs", {"rng": "seed"}), ("read_cam", {"rng": "seed"}),
    ("cam_by_hour", {"hour_start": 6, "hour_end": 24,
                     "n_sequences_per_hour": 2, "rng": "seed"}),
    ("rand_sample", {"rng": "seed", "panes_per_group": 2}),
    ("rand_sample", {"rng": "seed", "panes_per_group": 1,
                     "randomize_groups": True}),
])
def test_op_writes_the_jax_files(pgcs, tmp_path, op, kwargs):
    """The same files with the same contents; the seeded generator draws
    the same windows, breaths and pane groups in both."""
    jpgc, pgc = pgcs
    runs = {}
    for name, obj in (("jax", jpgc), ("port", pgc)):
        kw = {k: np.random.default_rng(3) if v == "seed" else v
              for k, v in kwargs.items()}
        _run(obj, str(tmp_path / name), op, **kw)
        runs[name] = str(tmp_path / name)
    assert_same_files(runs["port"], runs["jax"])


def test_cam_by_hour_payload(pgcs, tmp_path):
    """The pickled payload's keys, its (1, 2) model output and the
    ``target-<mode>`` file names of the JAX package."""
    _, pgc = pgcs
    _run(pgc, str(tmp_path), "cam_by_hour", hour_start=0, hour_end=7)
    files = tree(str(tmp_path))
    # 2 windows in [0, 7) x S breaths for each of 4 patients
    assert len(files) == len(PATIENTS) * 2 * S
    rel = sorted(files)[0]
    assert re.fullmatch(
        r"hour_sequences/(ards|non_ards)/\w+/0/seq-\d+-\d-target-"
        r"ground_truth\.pkl", rel)
    with open(files[rel][0], "rb") as f:
        payload = pickle.load(f)
    assert sorted(payload) == ["abs_idx", "breath", "cam", "model_output",
                               "patient", "seq_idx", "target"]
    assert payload["model_output"].shape == (1, 2)
    assert payload["cam"].shape == payload["breath"].shape == (L,)


def test_plot_grads_matches_jax(pgcs, tmp_path):
    """The recorded gradient norms by predicted class after ``medians``."""
    jpgc, pgc = pgcs
    for obj in (jpgc, pgc):
        obj.cam.grads.clear()
        obj.cam.preds.clear()
        _run(obj, str(tmp_path / str(id(obj))), "medians")
    got, want = pgc.plot_grads(), jpgc.plot_grads()
    for g, w in zip(got, want):
        assert g.shape == w.shape
        np.testing.assert_allclose(g, w, rtol=1e-5)
    assert sum(len(g) for g in got) == len(PATIENTS)


def _cams(pgcs, pt, target):
    """Both packages' raw and uint8 read cams of one patient, and its
    transformed windows."""
    jpgc, pgc = pgcs
    data = pgc._patient_data(pt)["data"]
    np.testing.assert_allclose(data, jpgc._patient_data(pt)["data"],
                               atol=1e-6, rtol=0)
    targets = np.full(len(data), target)
    want_raw, _ = jpgc.cam._batch_cam(jnp.asarray(data), jnp.asarray(targets))
    raw, _ = pgc.cam.read_cams_batch(data, targets)
    np.testing.assert_allclose(raw, np.asarray(want_raw), atol=1e-5, rtol=0)
    got, _ = pgc._read_cams_batch(data, targets)
    want, _ = jpgc._read_cams_batch(data, targets)
    _uint8_equal(got, want, _maxmin_scaled(np.asarray(want_raw)))
    return data, got, want, np.asarray(want_raw)


@pytest.mark.parametrize("pt", PATIENTS[:2])
def test_dtw_clust_stages_match_jax(pgcs, pt):
    """Cams, spans on the same upsampled cams, the matrix on the same
    spans, each stage alone."""
    jpgc, pgc = pgcs
    target = PATHO[PATIENTS.index(pt)]
    data, got, want, _ = _cams(pgcs, pt, target)
    cams224 = jgradcam.upsample_cam(want.reshape(-1, want.shape[-1]))
    np.testing.assert_allclose(
        gradcam.upsample_cam(want.reshape(-1, want.shape[-1])), cams224,
        rtol=1e-6, atol=1e-4)
    breaths = data[:, :, 0, :].reshape(-1, L)
    spans = pgc._cam_active_spans(cams224, breaths, 0.8, 5)
    want_spans = jpgc._cam_active_spans(cams224, breaths, 0.8, 5)
    assert len(spans) == len(want_spans) > 2
    for a, b in zip(spans, want_spans):
        np.testing.assert_array_equal(a, b)
    D = pgc._pairwise_dtw_matrix(spans)
    want_D = jpgc._pairwise_dtw_matrix(want_spans)
    assert D.dtype == np.float64 and D.shape == want_D.shape
    np.testing.assert_allclose(D, want_D, rtol=1e-6, atol=0)
    assert (D == D.T).all() and not np.diag(D).any()


def test_pairwise_matrix_chunks_and_small_inputs(pgcs):
    """Chunks of any size give the same matrix; under two spans it is
    zero."""
    _, pgc = pgcs
    rng = np.random.default_rng(4)
    spans = [rng.normal(size=n).astype(np.float32)
             for n in rng.integers(5, 40, size=9)]
    whole = pgc._pairwise_dtw_matrix(spans)
    np.testing.assert_array_equal(pgc._pairwise_dtw_matrix(spans, chunk=7),
                                  whole)
    assert pgc._pairwise_dtw_matrix(spans[:1]).shape == (1, 1)
    assert pgc._pairwise_dtw_matrix([]).shape == (0, 0)


def test_cam_active_spans_slice_the_run(pgcs):
    """A run at or above 0.8 x 255 of at least 5 samples is a span, sliced
    at the run itself (the JAX package's repair of the reference's group
    counter)."""
    jpgc, pgc = pgcs
    cam = np.zeros((2, L), np.float32)
    cam[0, 10:30] = 255.0
    cam[0, 50:53] = 255.0  # 3 samples: too short
    cam[0, 200:] = 204.0  # exactly at the threshold
    cam[1, 5:10] = 203.99
    br = np.arange(2 * L, dtype=np.float32).reshape(2, L)
    spans = pgc._cam_active_spans(cam, br)
    want = jpgc._cam_active_spans(cam, br)
    assert [s.tolist() for s in spans] == [w.tolist() for w in want] == [
        list(range(10, 30)), list(range(200, 224))]


def _explained(jax_cams224, port_cams224, raw_scaled, got, want, row):
    """A breath's spans differ only where its uint8 cams differ at a value
    within rounding of a step, or where an upsampled JAX cam value lies
    within float32 rounding of the threshold at a sample whose activity
    differs."""
    thresh = 0.8 * 255.0
    flips = (jax_cams224[row] >= thresh) != (port_cams224[row] >= thresh)
    step = got.reshape(-1, got.shape[-1])[row] != \
        want.reshape(-1, want.shape[-1])[row]
    near_step = np.abs(raw_scaled[row] - np.round(raw_scaled[row])) < 1e-3
    if step.any():
        return bool(near_step[step].all())
    return bool(flips.any()) and bool(
        (np.abs(jax_cams224[row][flips] - thresh) < 1e-3).all())


def test_dtw_clust_matches_jax(pgcs, tmp_path, monkeypatch):
    """The whole op: the same spans (or each difference explained), the
    matrix within rtol 1e-6, ``elbow.npz``'s clusters and span counts
    equal; its distortions within rtol 1e-6 when the port clusters the
    JAX package's matrix."""
    jpgc, pgc = pgcs
    captured = {"jax": [], "port": []}
    for name, obj in (("jax", jpgc), ("port", pgc)):
        orig = obj._cam_active_spans

        def spans(*args, _orig=orig, _name=name, **kw):
            captured[_name].append((args[0], _orig(*args, **kw)))
            return captured[_name][-1][1]
        monkeypatch.setattr(obj, "_cam_active_spans", spans)
    want = _run(jpgc, str(tmp_path / "jax"), "dtw_clust")
    got = _run(pgc, str(tmp_path / "port"), "dtw_clust")
    assert list(got) == list(want) == [
        (pt, y) for pt, y in zip(PATIENTS, PATHO)]
    for k, ((port_cams, spans), (jax_cams, jax_spans)) in enumerate(zip(
            captured["port"], captured["jax"])):
        key = list(want)[k]
        # the returned cams are those the spans were read from
        op_cams = got[key]["cams"]
        assert op_cams.dtype == np.uint8
        assert np.array_equal(gradcam.upsample_cam(
            op_cams.reshape(-1, op_cams.shape[-1])), port_cams)
        assert got[key]["outputs"].shape == (len(op_cams), 2)
        if [s.tolist() for s in spans] != [s.tolist() for s in jax_spans]:
            data, g, w, raw = _cams(pgcs, key[0], key[1])
            scaled = _maxmin_scaled(raw).reshape(-1, raw.shape[-1])
            rows = [r for r in range(len(port_cams))
                    if not np.array_equal(port_cams[r] >= 204.0,
                                          jax_cams[r] >= 204.0)]
            assert rows and all(_explained(jax_cams, port_cams, scaled, g, w,
                                           r) for r in rows)
            continue
        assert [s.tolist() for s in got[key]["spans"]] == \
            [s.tolist() for s in jax_spans]
        np.testing.assert_allclose(got[key]["distance_matrix"],
                                   want[key]["distance_matrix"], rtol=1e-6,
                                   atol=0)
        assert got[key]["clusters"] == want[key]["clusters"]
        assert got[key]["n_sequences"] == want[key]["n_sequences"]
    assert_elbows(str(tmp_path / "port"), str(tmp_path / "jax"),
                  distortions=False)

    # the same matrix on both sides: the port clusters the JAX matrices
    matrices = iter([r["distance_matrix"] for r in want.values()])
    monkeypatch.setattr(pgc, "_pairwise_dtw_matrix",
                        lambda spans, chunk=4096: next(matrices))
    _run(pgc, str(tmp_path / "port_same"), "dtw_clust")
    assert_elbows(str(tmp_path / "port_same"), str(tmp_path / "jax"))


def assert_elbows(got_root, want_root, distortions=True, patients=None):
    """The same ``elbow.npz`` files, one a (patient, target) of
    ``patients`` (default: every patient at its class)."""
    got, want = tree(got_root), tree(want_root)
    assert sorted(got) == sorted(want)
    assert sorted(want) == sorted(
        "dtw_clustering/{}/{}/elbow.npz".format(patient.PATHO_NAME[y], pt)
        for pt, y in patients or zip(PATIENTS, PATHO))
    for rel in want:
        with np.load(got[rel][0]) as a, np.load(want[rel][0]) as b:
            assert sorted(a.files) == sorted(b.files)
            np.testing.assert_array_equal(a["clusters"], b["clusters"])
            assert int(a["n_sequences"]) == int(b["n_sequences"])
            if distortions:
                np.testing.assert_allclose(a["distortions"],
                                           b["distortions"], rtol=1e-6,
                                           atol=0)


def test_stage_timer_records_dtw_clust(setup, tmp_path):
    """A timer records each stage once a patient and, on the CPU, no
    device events; without one nothing is recorded."""
    timer = patient.StageTimer()
    pgc = patient.PatientGradCam(setup["model"], setup["port"],
                                 results_dir=str(tmp_path), timer=timer)
    pgc.gt = pgc.gt.select(pgc.gt.patient == PATIENTS[0])
    (res,) = pgc.do_dtw_clust().values()
    assert set(timer.seconds) == {"cams", "spans", "upload", "dtw",
                                  "assembly", "kmedoids"}
    assert all(v >= 0 for v in timer.seconds.values())
    assert timer.device_ms == {} and res["n_sequences"] > 1
