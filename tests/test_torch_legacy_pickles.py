"""The reference's pickles read by the port with pandas, PyYAML and
pyarrow blocked (``data/legacy_pickle.py``), against the JAX package,
which reads them through pandas: a whole-dataset pickle carrying a cohort
DataFrame (``from_reference_pickle``), a ModelCollection and
``*_patient_results.pkl`` frames in both layouts of pandas' block manager
(``eval/legacy_results.py``, ``cli/mean_metrics.py``)."""
import io
import math
import pickle

import numpy as np
import pandas as pd
import pytest
import torch

import chip_smoke
from deepards_tpu.cli import mean_metrics as jmean
from deepards_tpu.data.dataset import ARDSRawDataset as JDataset
from deepards_tpu.eval import legacy_results as jlegacy
from deepards_tpu_torch.cli import mean_metrics as tmean
from deepards_tpu_torch.cli.train import main as train_main
from deepards_tpu_torch.data import legacy_pickle
from deepards_tpu_torch.data.dataset import ARDSRawDataset as TDataset
from deepards_tpu_torch.data.synthetic import generate_cohort
from deepards_tpu_torch.eval import legacy_results as tlegacy
from torch_legacy_frames import frame_bytes, stand_in_modules

torch.set_num_threads(1)

BLOCKED = ("pandas", "yaml", "pyarrow")
STORE_COLUMNS = ["patient", "patho", "OTHER_tps", "OTHER_fps", "OTHER_tns",
                 "OTHER_fns", "OTHER_votes", "ARDS_tps", "ARDS_fps",
                 "ARDS_tns", "ARDS_fns", "ARDS_votes", "prediction",
                 "pred_frac", "epoch_num", "fold_num"]


@pytest.fixture(autouse=True)
def object_strings():
    """Frames pickled as the reference's pandas wrote them: str columns
    of object dtype."""
    with pd.option_context("future.infer_string", False):
        yield


def same(a, b):
    if isinstance(a, float) and isinstance(b, float) and math.isnan(a):
        return math.isnan(b)
    return a == b


def same_rows(got, want):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert list(g) == list(w)
        assert all(same(g[k], w[k]) for k in g), (g, w)


def _records(kind, rng):
    """all_sequences records of the reference's 4-, 5- and 6-field kinds
    (and the regression record: (1, 224) data, [nan] hours)."""
    out = []
    for pt in ("0012RPI0120150401", "0034RPI0120150402", "7", "8"):
        for i in range(3):
            hours = [0.25 * i + 0.01 * s for s in range(4)]
            target = np.eye(2, dtype=np.float32)[len(out) % 2]
            data = rng.normal(size=(4, 1, 224)).astype(np.float32)
            meta = rng.normal(size=9).astype(np.float32)
            if kind == "4":
                out.append([pt, data, target, hours])
            elif kind == "5":
                out.append([pt, data, meta, target, hours])
            elif kind == "6":
                out.append([pt, data, meta, meta * 2, target, hours])
            else:
                out.append([pt, data[0], meta, [np.nan]])
    return out


def _dataset_pickle(path, records, kfolds, cohort=None):
    made, remove = stand_in_modules("dataset", ["ARDSRawDataset"])
    try:
        obj = made["ARDSRawDataset"]()
        obj.all_sequences = records
        obj.dataset_type = "unpadded_centered_sequences"
        obj.total_kfolds = kfolds
        obj.kfold_num = 0 if kfolds else None
        obj.experiment_num = 1
        obj.drop_i_lim = True
        obj.unpadded_downsample_factor = 2.0
        if cohort is not None:
            obj.cohort = cohort
        with open(path, "wb") as f:
            pickle.dump(obj, f)
    finally:
        remove()


@pytest.mark.parametrize("kind", ["4", "5", "6", "regression"])
def test_reference_dataset_pickle_gives_the_jax_cache(kind, tmp_path):
    rng = np.random.default_rng(3)
    cohort = pd.DataFrame({
        "Patient Unique Identifier": ["0012RPI0120150401", "7"],
        "Pathophysiology": ["ARDS", "COPD"], "experiment_group": [1, 1],
        "hours": [24.5, np.nan]})
    path = str(tmp_path / "reference.pkl")
    # a regression dataset is a holdout one: no folds
    _dataset_pickle(path, _records(kind, rng),
                    None if kind == "regression" else 2, cohort)
    want = JDataset.from_reference_pickle(path)
    with chip_smoke.blocked_modules(*BLOCKED):
        got = TDataset.from_reference_pickle(path)
        frame = legacy_pickle.load(path).cohort
    for key in ("data", "target", "hours", "patient_idx"):
        np.testing.assert_array_equal(getattr(got.cache, key),
                                      getattr(want.cache, key))
        assert getattr(got.cache, key).dtype == getattr(want.cache, key).dtype
    assert got.cache.patients == want.cache.patients
    if want.cache.meta is None:
        assert got.cache.meta is None
    else:
        np.testing.assert_array_equal(got.cache.meta, want.cache.meta)
    for key in ("dataset_type", "total_kfolds", "kfold_num", "experiment_num",
                "drop_i_lim", "unpadded_downsample_factor", "seed"):
        assert getattr(got, key) == getattr(want, key), key
    # the cohort frame, decoded without pandas
    assert frame.columns == list(cohort.columns)
    same_rows(frame.rows(), cohort.to_dict("records"))


def test_a_fold_trains_from_the_pickle_as_from_the_npz(tmp_path):
    """The reference pickle of a cohort's windows gives the .npz's cache
    exactly and, trained for one fold, the same losses."""
    cohort = generate_cohort(str(tmp_path / "cohort"), n_patients=10,
                             n_breaths_per_patient=80, seed=4)
    ds = TDataset(str(tmp_path / "cohort"), 1, cohort, 4,
                  "unpadded_centered_sequences", kfold_num=0,
                  total_kfolds=5)
    npz = ds.save(str(tmp_path / "dataset.npz"))
    ref = chip_smoke.write_reference_pickle(
        str(tmp_path / "reference.pkl"), ds.cache, ds.dataset_type)
    shifted = chip_smoke.write_reference_pickle(
        str(tmp_path / "shifted.pkl"), ds.cache, ds.dataset_type, 2)
    base = chip_smoke.CONFIG1_FLAGS + [
        "--n-sub-batches", "4", "--batch-size", "8", "--only-fold", "0",
        "--epochs", "1", "--device", "cpu", "--compute-dtype", "float32"]
    losses = {}
    with chip_smoke.blocked_modules(*BLOCKED):
        assert chip_smoke.cache_diff(TDataset.from_pickle(ref).cache,
                                     ds.cache) == []
        assert chip_smoke.cache_diff(TDataset.from_pickle(shifted).cache,
                                     ds.cache) == ["hours"]
        for name, path in (("npz", npz), ("reference", ref)):
            trainer = train_main(base + [
                "--train-from-pickle", path, "--results-dir",
                str(tmp_path / name)])
            meters = trainer.results.reporting.meters
            losses[name] = [meters[k].values for k in (
                "loss_fold_0", "test_loss_fold_0")]
    assert losses["npz"][0] and losses["npz"] == losses["reference"]


def test_model_collection_gives_the_jax_rows(tmp_path):
    made, remove = stand_in_modules("results", [
        "ModelCollection", "ModelResults", "PatientResults"])
    try:
        collection = made["ModelCollection"]()
        collection.models = []
        for model_idx in range(3):
            model = made["ModelResults"]()
            model.all_patient_results = []
            for i, (pt, other, ards, gt) in enumerate((
                    ("0012RPI", 10, 30, 1), ("0034RPI", 25, 5, 0),
                    ("7", 0, 0, 0), ("8", 12, 12, 1))):
                patient = made["PatientResults"]()
                patient.__dict__.update(
                    patient_id=pt, other_votes=other + model_idx,
                    ards_votes=ards, majority_prediction=int(ards > other),
                    fold_idx=i % 2, model_idx=model_idx, ground_truth=gt)
                model.all_patient_results.append(patient)
            collection.models.append(model)
        path = str(tmp_path / "model_collection_results_1.pkl")
        with open(path, "wb") as f:
            pickle.dump(collection, f)
    finally:
        remove()
    want = jlegacy.load_model_collection(path)
    with chip_smoke.blocked_modules(*BLOCKED):
        got = tlegacy.load_model_collection(path)
        voted = [r for r in got if r["patient_id"] != "7"]
        stats = tlegacy.calc_aggregate_stats(voted)
        # patient 7 has no votes: its NaN fraction fails the AUC, as
        # scikit-learn's roc_curve fails the JAX run
        with pytest.raises(ValueError, match="NaN"):
            tlegacy.calc_aggregate_stats(got)
    same_rows(got, want.to_dict("records"))
    same_rows(stats, jlegacy.calc_aggregate_stats(
        want[want.patient_id != "7"]).to_dict("records"))
    with pytest.raises(ValueError, match="NaN"):
        jlegacy.calc_aggregate_stats(want)


LEGACY = {
    "patient_id": np.array(["0012RPI", "0034RPI", "7", "8", "0012RPI",
                            "0034RPI", "7", "8"], dtype=object),
    "other_votes": np.array([10, 25, 0, 12, 11, 20, 3, 2]),
    "ards_votes": np.array([30, 5, 0, 12, 29, 10, 1, 22]),
    "frac_votes": np.array([0.75, 1 / 6, np.nan, 0.5, 29 / 40, 1 / 3, 0.25,
                            22 / 24]),
    "majority_prediction": np.array([1, 0, 0, 1, 1, 0, 0, 1]),
    "fold_idx": np.array([0, 1, 0, 1, 0, 1, 0, 1]),
    "model_idx": np.array([0, 0, 0, 0, 1, 1, 1, 1]),
    "ground_truth": np.array([1, 0, 0, 1, 1, 1, 0, 1]),
}


def _frame_file(path, columns, layout):
    """``columns`` pickled as a DataFrame: by pandas itself (``pandas3``)
    or in the 0.14.1 layout of pandas 0.14-2 and numpy 1 (``0.14.1``)."""
    if layout == "pandas3":
        pd.DataFrame(columns).to_pickle(path)
    else:
        with open(path, "wb") as f:
            f.write(frame_bytes(columns))
    return path


@pytest.mark.parametrize("layout", ["pandas3", "0.14.1"])
def test_legacy_patient_results_give_the_jax_rows(layout, tmp_path):
    path = _frame_file(str(tmp_path / "1_patient_results.pkl"), LEGACY,
                       layout)
    want = jlegacy.load_legacy_patient_results(path)
    voted = want[want.frac_votes.notna()]
    with chip_smoke.blocked_modules(*BLOCKED):
        got = tlegacy.load_legacy_patient_results(path)
        kept = [r for r in got if r["frac_votes"] == r["frac_votes"]]
        stats = {t: tlegacy.calc_aggregate_stats(kept, t) for t in (0.5, 70)}
        counts = tlegacy.count_predictions(got, 0.5)
        lifted = tlegacy.legacy_to_new_store(kept)
    same_rows(got, want.to_dict("records"))
    for threshold, rows in stats.items():
        same_rows(rows, jlegacy.calc_aggregate_stats(
            voted, threshold).to_dict("records"))
    assert counts == jlegacy.count_predictions(want, 0.5)
    same_rows(lifted, jlegacy.legacy_to_new_store(voted).to_dict("records"))


def _store(rng, n_patients=6, epochs=2, folds=2):
    rows = []
    for fold in range(folds):
        for epoch in range(1, epochs + 1):
            for p in range(n_patients):
                other, ards = (int(v) for v in rng.integers(0, 20, 2))
                patho = p % 2
                pred = int(ards > other)
                row = {"patient": "{:04d}RPI".format(p), "patho": patho}
                for i, name in enumerate(("OTHER", "ARDS")):
                    hit, truth = pred == i, patho == i
                    row.update({name + "_tps": int(hit and truth),
                                name + "_fps": int(hit and not truth),
                                name + "_tns": int(not hit and not truth),
                                name + "_fns": int(not hit and truth)})
                row.update(OTHER_votes=other, ARDS_votes=ards,
                           prediction=pred,
                           pred_frac=ards / (other + ards) if other + ards
                           else 0.0, epoch_num=epoch, fold_num=fold)
                rows.append(row)
    return {c: np.asarray([r[c] for r in rows],
                          dtype=object if c == "patient" else None)
            for c in STORE_COLUMNS}


@pytest.mark.parametrize("layout", ["pandas3", "0.14.1"])
def test_mean_metrics_reads_patient_results_frames(layout, tmp_path):
    rng = np.random.default_rng(11)
    files = [_frame_file(str(tmp_path / "{}_patient_results.pkl".format(i)),
                         _store(rng), layout) for i in range(3)]
    want, want_stats = jmean.get_metrics(files)
    with chip_smoke.blocked_modules(*BLOCKED):
        got, stats = tmean.get_metrics(files)
        by_dir = tmean.main(["--results-dir", str(tmp_path)])
        legacy = tlegacy.load_legacy_patient_results(files[0])
    assert list(got) == list(want.columns)
    for column in want.columns:
        np.testing.assert_array_equal(got[column], want[column].to_numpy())
        np.testing.assert_array_equal(by_dir[column], want[column].to_numpy())
    # the AUC of eval.metrics and scikit-learn's part by rounding
    for column in want_stats.columns:
        np.testing.assert_allclose(stats[column],
                                   want_stats[column].to_numpy(np.float64),
                                   rtol=0, atol=1e-12)
    # the JAX new_store_to_legacy reads lowercase vote columns, which its
    # own results store does not write; the port reads the store's
    with pytest.raises(KeyError, match="other_votes"):
        jlegacy.load_legacy_patient_results(files[0])
    frame = pd.read_pickle(files[0]).rename(columns={
        "OTHER_votes": "other_votes", "ARDS_votes": "ards_votes"})
    same_rows(legacy, jlegacy.new_store_to_legacy(frame).to_dict("records"))


def test_undecodable_frames_raise_by_name(tmp_path):
    with pd.option_context("future.infer_string", True):
        pd.DataFrame({"patient": ["a", "b"], "patho": [0, 1]}).to_pickle(
            str(tmp_path / "arrow.pkl"))
    pd.DataFrame({"patient": ["a", "b"],
                  "group": pd.Categorical(["x", "y"])}).to_pickle(
        str(tmp_path / "categorical.pkl"))
    with open(str(tmp_path / "series.pkl"), "wb") as f:
        pickle.dump(pd.Series([1, 2]), f)
    with chip_smoke.blocked_modules(*BLOCKED):
        with pytest.raises(legacy_pickle.LegacyPickleError,
                           match="column index holds a "
                           "pandas.arrays.ArrowStringArray"):
            legacy_pickle.load_frame(str(tmp_path / "arrow.pkl"))
        with pytest.raises(legacy_pickle.LegacyPickleError,
                           match="column.s. 'group' hold a pandas"):
            legacy_pickle.load_frame(str(tmp_path / "categorical.pkl"))
        with pytest.raises(legacy_pickle.LegacyPickleError,
                           match=r"holds a pandas\S*Series, not a "
                           "DataFrame"):
            legacy_pickle.load_frame(str(tmp_path / "series.pkl"))


def test_numpy_1_names_load(tmp_path):
    """numpy 1 pickled arrays as ``numpy.core.multiarray``; numpy 2's
    ``numpy._core`` loads too, with no pandas."""
    array = np.arange(6, dtype=np.int64).reshape(2, 3)
    data = pickle.dumps({"a": array}, protocol=2)
    old = data.replace(b"cnumpy._core.multiarray\n",
                       b"cnumpy.core.multiarray\n")
    assert old != data
    for blob in (data, old):
        with chip_smoke.blocked_modules(*BLOCKED):
            got = legacy_pickle.LegacyUnpickler(io.BytesIO(blob)).load()
        np.testing.assert_array_equal(got["a"], array)
