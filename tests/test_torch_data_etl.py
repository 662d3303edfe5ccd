"""The port's ETL against the JAX package, exactly: the window cache of
every dataset type the CLI offers, the 5-fold patient splits (shuffled
and not), the per-fold scaling factors, the oversampled train indexes,
the ground truth, the ``.npz`` dataset format in both directions, and
the reference's pickle."""
import numpy as np
import pytest
import torch

import chip_smoke
from deepards_tpu.cli.train import DATASET_TYPES
from deepards_tpu.data.dataset import ARDSRawDataset as JaxDataset
from deepards_tpu_torch.data import pipeline
from deepards_tpu_torch.data.dataset import ARDSRawDataset
from deepards_tpu_torch.data.synthetic import generate_cohort

# parallel test workers share the cores: one torch thread each
torch.set_num_threads(1)

CACHE_ARRAYS = ("data", "target", "hours", "patient_idx")


def _assert_same_cache(got, want):
    for name in CACHE_ARRAYS:
        a, b = getattr(got, name), getattr(want, name)
        assert a.dtype == b.dtype and a.shape == b.shape, name
        np.testing.assert_array_equal(a, b, err_msg=name)
    assert got.patients == want.patients
    assert got.frames_dropped == want.frames_dropped
    if want.meta is None:
        assert got.meta is None
    else:
        np.testing.assert_array_equal(got.meta, want.meta)


@pytest.mark.parametrize("dataset_type", DATASET_TYPES)
def test_window_cache_equal_for_every_dataset_type(synthetic_cohort,
                                                   dataset_type):
    args = (synthetic_cohort["data_path"], 1, synthetic_cohort["cohort_file"],
            4, dataset_type)
    got = ARDSRawDataset(*args)
    want = JaxDataset(*args)
    _assert_same_cache(got.cache, want.cache)
    assert got.scaling_factors.keys() == want.scaling_factors.keys()
    for k in want.scaling_factors:
        for a, b in zip(got.scaling_factors[k], want.scaling_factors[k]):
            np.testing.assert_array_equal(a, b)


@pytest.fixture(scope="module")
def ten_patients(tmp_path_factory):
    """Five patients a class: enough for 5 stratified folds."""
    path = str(tmp_path_factory.mktemp("ten"))
    cohort = generate_cohort(path, n_patients=10, n_breaths_per_patient=120,
                             seed=7)
    return path, cohort


def _kfold_pair(ten_patients, **kw):
    path, cohort = ten_patients
    args = (path, 1, cohort, 4, "unpadded_centered_sequences")
    kw = dict(kfold_num=0, total_kfolds=5, oversample_minority=True, seed=9,
              **kw)
    train = ARDSRawDataset(*args, **kw)
    jtrain = JaxDataset(*args, **kw)
    return ((train, ARDSRawDataset.make_test_dataset_if_kfold(train)),
            (jtrain, JaxDataset.make_test_dataset_if_kfold(jtrain)))


@pytest.mark.parametrize("random_kfold", [False, True])
def test_folds_scaling_and_oversampling_equal(ten_patients, random_kfold):
    (train, test), (jtrain, jtest) = _kfold_pair(
        ten_patients, random_kfold=random_kfold)
    _assert_same_cache(train.cache, jtrain.cache)
    for k in range(5):
        assert (train.kfold_patient_splits[k]["test"].tolist()
                == jtrain.kfold_patient_splits[k]["test"].tolist())
        for a, b in zip(train.scaling_factors[k], jtrain.scaling_factors[k]):
            np.testing.assert_array_equal(a, b)
    for k in range(5):
        for ds, jds in ((train, jtrain), (test, jtest)):
            ds.set_kfold_indexes_for_fold(k)
            jds.set_kfold_indexes_for_fold(k)
            # oversampled train indexes, drawn from the same stream
            assert ds.current_indices().tolist() == \
                jds.current_indices().tolist()
        truth = test.get_ground_truth()
        want = jtest.get_ground_truth_df()
        assert truth.index.tolist() == want.index.tolist()
        assert truth.patient.tolist() == want.patient.tolist()
        assert truth.y.tolist() == want.y.tolist()
        np.testing.assert_array_equal(truth.hour, want.hour.to_numpy())
    train.set_oversampling_indices()
    jtrain.set_oversampling_indices()
    assert train.current_indices().tolist() == \
        jtrain.current_indices().tolist()


def test_npz_round_trip_both_ways(ten_patients, tmp_path):
    (train, _), (jtrain, _) = _kfold_pair(ten_patients)
    port_file = train.save(str(tmp_path / "port.pkl"))
    jax_file = jtrain.save(str(tmp_path / "jax.npz"))
    assert port_file.endswith("port.npz")
    for path in (port_file, jax_file):
        got = ARDSRawDataset.from_pickle(path, oversample_minority=True,
                                         seed=9)
        want = JaxDataset.from_pickle(path, oversample_minority=True, seed=9)
        _assert_same_cache(got.cache, want.cache)
        _assert_same_cache(got.cache, train.cache)
        for k in range(5):
            got.set_kfold_indexes_for_fold(k)
            want.set_kfold_indexes_for_fold(k)
            assert got.current_indices().tolist() == \
                want.current_indices().tolist()
            for a, b in zip(got.scaling_for_current_fold(),
                            want.scaling_for_current_fold()):
                np.testing.assert_array_equal(a, b)
    # any other path is the reference's pickle, read without pandas
    ref = chip_smoke.write_reference_pickle(
        str(tmp_path / "reference.pkl"), train.cache, train.dataset_type)
    got = ARDSRawDataset.from_pickle(ref)
    assert chip_smoke.cache_diff(got.cache, train.cache) == []
    assert chip_smoke.cache_diff(
        got.cache, JaxDataset.from_pickle(ref).cache) == []


def test_unported_batch_transforms_raise(ten_patients):
    """The dataset's batch transforms, once refused, now run: a pipeline
    needs its device named (without one it raises), normalizes, and
    filters as the dataset asks."""
    (train, _), _ = _kfold_pair(ten_patients)
    with pytest.raises(TypeError):
        pipeline.BatchPipeline(train)
    pipe = pipeline.BatchPipeline(train, "cpu")
    x = train.cache.data[:2]
    mu, std = train.scaling_for_current_fold()
    np.testing.assert_allclose(pipeline.gather_pipeline(train)(x),
                               (x - mu[0]) / std[0], rtol=1e-6)
    assert not pipe.is_padded
    train.butter_low = 0.5
    sos = pipeline.design_butter_sos(0.5, None)
    want = pipeline.sosfilt(sos, torch.from_numpy((x - mu[0]) / std[0]))
    np.testing.assert_allclose(pipeline.gather_pipeline(train)(x),
                               want.numpy(), atol=1e-5, rtol=0)


def test_cohort_without_start_time_raises(tmp_path):
    path = str(tmp_path)
    cohort = generate_cohort(path, n_patients=2, n_breaths_per_patient=40,
                             seed=1)
    with open(cohort) as f:
        text = f.read()
    # patient 2 is ARDS: drop its Berlin date
    with open(cohort, "w") as f:
        f.write(text.replace("2,ARDS,2017-01-01 00:00:00", "2,ARDS,"))
    with pytest.raises(ValueError, match="valid start time"):
        ARDSRawDataset(path, 1, cohort, 4, "unpadded_centered_sequences",
                       kfold_num=0, total_kfolds=2)
