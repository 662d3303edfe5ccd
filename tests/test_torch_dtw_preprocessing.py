"""Training's DTW preprocessing on the CPU against the JAX package.

``eval.plots.process_pred_to_hour_for_dtw`` and
``perform_dtw_preprocessing`` on the seeded 4-patient cohort of
``test_torch_patient_gradcam.py`` (S = 3, 2 folds, the ``.npz`` both
packages read): the expanded rows' index, hour and patient equal, each
patient's DTW frame with its index and hours equal and its scores within
rtol 1e-6 (the JAX package scores through its scan, the port through
``dtw_reference``).  Then a whole 2-fold ``cli.train
--perform-dtw-preprocessing`` run of each package on the shared
synthetic cohort (S = 4, 1 epoch): the cached frames of the last fold's
test patients compared the same way.  The frames read the windows and
their hours, not the predictions, so the runs' own rounding does not
enter.
"""
import glob
import os
from types import SimpleNamespace

import numpy as np
import pandas as pd
import pytest
import torch
from test_torch_patient_gradcam import save_cohort

import chip_smoke
from deepards_tpu.cli import train as jtrain
from deepards_tpu.data.dataset import ARDSRawDataset as JaxDataset
from deepards_tpu.eval import plots as jplots
from deepards_tpu_torch.cli import train as ttrain
from deepards_tpu_torch.data.dataset import ARDSRawDataset
from deepards_tpu_torch.eval import plots

# parallel test workers share the cores: one torch thread each
torch.set_num_threads(1)

DTW_RTOL = 1e-6


def views(path, fold):
    """(JAX, port) test views of the saved dataset at ``fold``."""
    out = []
    for cls in (JaxDataset, ARDSRawDataset):
        test = cls.make_test_dataset_if_kfold(cls.from_pickle(path))
        test.set_kfold_indexes_for_fold(fold)
        out.append(test)
    return out


@pytest.fixture(scope="module")
def cohort(tmp_path_factory):
    return save_cohort(str(tmp_path_factory.mktemp("dtw_pre")),
                       total_kfolds=2)


def prediction_rows(dataset, seed=0):
    """The port's ``pred_to_hour_frame`` rows of ``dataset``'s windows
    with drawn predictions, and the JAX package's frame of them."""
    truth = dataset.get_ground_truth()
    preds = np.random.default_rng(seed).integers(0, 2, len(truth.index))
    rows = [{"index": int(i), "pred": int(p), "hour": float(h),
             "patient": str(pt), "y": int(y)}
            for i, p, h, pt, y in zip(truth.index, preds, truth.hour,
                                      truth.patient, truth.y)]
    frame = pd.DataFrame({k: [r[k] for r in rows]
                          for k in ("pred", "hour", "patient", "y")},
                         index=[r["index"] for r in rows])
    return rows, frame


def assert_same_frames(got, want):
    """{patient: DTWFrame} against {patient: JAX frame}: the patients in
    order, index and hours equal, scores within DTW_RTOL."""
    assert list(got) == list(want) and got
    for pt, frame in want.items():
        np.testing.assert_array_equal(got[pt].index, frame.index.to_numpy())
        np.testing.assert_array_equal(got[pt].hour, frame.hour.to_numpy())
        np.testing.assert_allclose(got[pt].dtw, frame.dtw.to_numpy(),
                                   rtol=DTW_RTOL, atol=0)
        assert np.isfinite(got[pt].dtw[3:]).all()


@pytest.mark.parametrize("fold", [0, 1])
def test_process_pred_to_hour_matches_jax(cohort, fold):
    jax_ds, port_ds = views(cohort, fold)
    rows, frame = prediction_rows(port_ds)
    want = jplots.process_pred_to_hour_for_dtw(frame, jax_ds)
    got = plots.process_pred_to_hour_for_dtw(rows, port_ds)
    assert len(want) == 3 * len(rows)
    np.testing.assert_array_equal(got["index"], want.index.to_numpy())
    np.testing.assert_array_equal(got["hour"], want.hour.to_numpy())
    np.testing.assert_array_equal(got["patient"], want.patient.to_numpy())
    np.testing.assert_array_equal(got["pred"], want.pred.to_numpy())


@pytest.mark.parametrize("fold", [0, 1])
def test_perform_dtw_preprocessing_matches_jax(cohort, tmp_path, fold):
    jax_ds, port_ds = views(cohort, fold)
    rows, frame = prediction_rows(port_ds, seed=fold)
    want = jplots.perform_dtw_preprocessing(
        SimpleNamespace(pred_to_hour_frame=frame), jax_ds,
        str(tmp_path / "jax"))
    got = plots.perform_dtw_preprocessing(
        SimpleNamespace(pred_to_hour_frame=rows), port_ds,
        str(tmp_path / "port"), device="cpu")
    assert_same_frames(got, want)
    # a second call reads the cache
    cached = plots.perform_dtw_preprocessing(
        SimpleNamespace(pred_to_hour_frame=rows), port_ds,
        str(tmp_path / "port"), device="cpu")
    for pt, f in got.items():
        np.testing.assert_array_equal(cached[pt].dtw, f.dtw)


def test_hours_shifted_by_a_breath_are_caught(cohort, tmp_path):
    """The comparison fails a frame whose hours moved by one breath."""
    jax_ds, port_ds = views(cohort, 0)
    rows, frame = prediction_rows(port_ds)
    want = jplots.perform_dtw_preprocessing(
        SimpleNamespace(pred_to_hour_frame=frame), jax_ds,
        str(tmp_path / "jax"))
    got = plots.perform_dtw_preprocessing(
        SimpleNamespace(pred_to_hour_frame=rows), port_ds,
        str(tmp_path / "port"), device="cpu")
    pt = next(iter(got))
    got[pt] = got[pt]._replace(hour=np.roll(got[pt].hour, 1))
    with pytest.raises(AssertionError):
        assert_same_frames(got, want)


def cache_frames(root, ext):
    """{patient: frame} of a run's ``dtw_cache`` (JAX ``.pkl`` frames or
    the port's ``.npz``), patients in file order."""
    out = {}
    for path in sorted(glob.glob(os.path.join(root, "dtw_cache", "*",
                                              "*" + ext))):
        pt = os.path.basename(os.path.dirname(path))
        if ext == ".pkl":
            out[pt] = pd.read_pickle(path)
        else:
            with np.load(path) as z:
                out[pt] = SimpleNamespace(index=z["index"], dtw=z["dtw"],
                                          hour=z["hour"])
    return out


def run_flags(cohort, extra=()):
    return chip_smoke.CONFIG1_FLAGS + [
        "--data-path", cohort["data_path"], "--cohort-file",
        cohort["cohort_file"], "--n-sub-batches", "4", "--batch-size", "8",
        "--kfolds", "2", "--epochs", "1", "--perform-dtw-preprocessing",
    ] + list(extra)


def whole_runs(synthetic_cohort, root, extra=()):
    """A 2-fold run of each package; (port trainer, JAX cache frames)."""
    flags = run_flags(synthetic_cohort, extra)
    with pytest.MonkeyPatch.context() as mp:
        os.makedirs(root / "jax")
        mp.chdir(root / "jax")
        jtrain.main(flags + ["--results-dir", str(root / "jax" / "r")])
        os.makedirs(root / "port")
        mp.chdir(root / "port")
        trainer = ttrain.main(flags + ["--results-dir",
                                       str(root / "port" / "r"),
                                       "--device", "cpu"])
    return trainer, cache_frames(str(root / "jax"), ".pkl")


def assert_run_frames(trainer, want, root):
    got = trainer.dtw_frames
    assert sorted(got) == sorted(want)
    # the frames cached under the run's directory are the ones returned
    cached = cache_frames(str(root / "port"), ".npz")
    assert sorted(cached) == sorted(got)
    for pt in got:
        np.testing.assert_array_equal(cached[pt].dtw, got[pt].dtw)
    # the patients of the last predictions: the last fold's test split
    assert sorted(got) == sorted({r["patient"] for r in
                                  trainer.results.pred_to_hour_frame})
    assert_same_frames({pt: got[pt] for pt in want}, want)


def test_sequential_run_matches_jax(synthetic_cohort, tmp_path):
    trainer, want = whole_runs(synthetic_cohort, tmp_path)
    assert_run_frames(trainer, want, tmp_path)
