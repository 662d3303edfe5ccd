"""The 2D breath-image dataset and its transforms against the JAX package.

The same synthetic cohort through both packages' ``ARDSRawDataset`` (S =
4, 2 folds) and ``ImgARDSDataset``: images, FFT channels (rows rolled by
H//2, as the reference's fftshift does), scaling factors, k-fold indexes
with oversampling, bbox boxes, labels and splices, patho-mix images, the
Butterworth filter, every 2D transform and the ground truth, all exactly
equal.  A planted fault (FFT channels without the row roll) must fail the
image check.

The JAX package's fault is pinned: its trainer builds the test split of a
``with_fft`` run without the FFT channels, so ``gather`` broadcasts the
one flow image against the train split's three-channel scaling; the
port's test split has the train split's channels.
"""
import os

import numpy as np
import pytest
import torch

import deepards_tpu.train.loop as jloop
import deepards_tpu_torch.train.loop as tloop
from deepards_tpu.config import Configuration as JaxConfiguration
from deepards_tpu.data.dataset import ARDSRawDataset as JaxRawDataset
from deepards_tpu.data.img_dataset import ImgARDSDataset as JaxImgDataset
from deepards_tpu.data.img_transforms import (
    two_dim_transforms as jax_transforms,
)
from deepards_tpu_torch.config.config import Configuration
from deepards_tpu_torch.data.dataset import ARDSRawDataset
from deepards_tpu_torch.data.img_dataset import (
    ImgARDSDataset,
    image_channels,
)
from deepards_tpu_torch.data.img_transforms import two_dim_transforms

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope="module")
def raws(synthetic_cohort):
    """(port, JAX) raw datasets of the shared cohort, fold 0 of 2."""
    args = (synthetic_cohort["data_path"], 1,
            synthetic_cohort["cohort_file"], 4)
    kw = dict(dataset_type="unpadded_centered_sequences", kfold_num=0,
              total_kfolds=2, oversample_minority=True)
    return ARDSRawDataset(*args, **kw), JaxRawDataset(*args, **kw)


def assert_images_equal(port, jax_ds):
    np.testing.assert_array_equal(port.images, jax_ds.images)
    np.testing.assert_array_equal(port.patient_idx, jax_ds.patient_idx)
    assert port.patients == jax_ds.patients
    np.testing.assert_array_equal(port.target, jax_ds.target)
    np.testing.assert_array_equal(port.hours, jax_ds.hours)


@pytest.mark.parametrize("options,channels", [
    ({}, 1), ({"add_fft": True}, 3), ({"fft_only": True}, 2),
    ({"add_fft": True, "fft_real_only": True}, 2),
    ({"fft_only": True, "fft_real_only": True}, 1),
    ({"add_fft": True, "fft_only": True}, 3)],
    ids=["flow", "add_fft", "fft_only", "add_fft_real", "fft_only_real",
         "add_fft_and_fft_only"])
def test_images_and_scaling_match_jax(raws, options, channels):
    port = ImgARDSDataset(raws[0], **options)
    jax_ds = JaxImgDataset(raws[1], **options)
    assert_images_equal(port, jax_ds)
    # the trainer sizes the backbone by image_channels before any image
    assert port.data_shape == (channels, 224, 224)
    assert image_channels(**options) == channels
    assert port.scaling_factors.keys() == jax_ds.scaling_factors.keys()
    for k, (mu, std) in jax_ds.scaling_factors.items():
        np.testing.assert_array_equal(port.scaling_factors[k][0], mu)
        np.testing.assert_array_equal(port.scaling_factors[k][1], std)
    for fold in (0, 1):
        port.set_kfold_indexes_for_fold(fold)
        jax_ds.set_kfold_indexes_for_fold(fold)
        np.testing.assert_array_equal(port.kfold_indexes,
                                      jax_ds.kfold_indexes)
        idx = port.current_indices()[:5]
        got, want = port.gather(idx), jax_ds.gather(idx)
        for key in ("index", "data", "target"):
            np.testing.assert_array_equal(got[key], want[key])
    truth, frame = port.get_ground_truth(), jax_ds.get_ground_truth_df()
    np.testing.assert_array_equal(truth.index, frame.index.values)
    np.testing.assert_array_equal(truth.patient, frame.patient.values)
    np.testing.assert_array_equal(truth.y, frame.y.values)
    np.testing.assert_array_equal(truth.hour, frame.hour.values)


class _UnrolledFFT(ImgARDSDataset):
    """Planted fault: FFT channels centred over W only, the rows not
    rolled."""

    def _fft_channels(self, img):
        trans = np.fft.fftshift(np.fft.fft(img, axis=2), axes=(2,))
        return np.concatenate(
            [img, trans.real.astype(np.float32),
             trans.imag.astype(np.float32)], axis=0)


def test_fft_check_fails_rows_not_rolled(raws):
    jax_ds = JaxImgDataset(raws[1], add_fft=True)
    with pytest.raises(AssertionError):
        assert_images_equal(_UnrolledFFT(raws[0], add_fft=True), jax_ds)
    # the roll is the only difference: H//2 rows
    planted = _UnrolledFFT(raws[0], add_fft=True).images
    np.testing.assert_array_equal(
        np.roll(planted[:, 1:], 112, axis=2), jax_ds.images[:, 1:])


@pytest.mark.parametrize("same_patho_mix,bbox", [(False, True),
                                                 (True, False)],
                         ids=["bbox", "patho_mix"])
def test_derived_datasets_match_jax(raws, same_patho_mix, bbox):
    port = ImgARDSDataset(raws[0], bbox=bbox, same_patho_mix=same_patho_mix,
                          seed=5)
    jax_ds = JaxImgDataset(raws[1], bbox=bbox, same_patho_mix=same_patho_mix,
                           seed=5)
    assert port.mixed_images is not None
    np.testing.assert_array_equal(port.mixed_images, jax_ds.mixed_images)
    assert not np.array_equal(port.mixed_images, port.images)
    if bbox:
        for key in ("boxes", "labels"):
            np.testing.assert_array_equal(port.bbox_targets[key],
                                          jax_ds.bbox_targets[key])
        got, want = port.gather([0, 3]), jax_ds.gather([0, 3])
        for key in ("data", "boxes", "labels"):
            np.testing.assert_array_equal(got[key], want[key])
    np.testing.assert_array_equal(port.kfold_indexes, jax_ds.kfold_indexes)


def test_gather_with_transforms_and_filter_matches_jax(raws):
    names = list(jax_transforms)
    port = ImgARDSDataset(raws[0], extra_transforms=names, butter_filter=1,
                          seed=3)
    jax_ds = JaxImgDataset(raws[1], extra_transforms=names, butter_filter=1,
                           seed=3)
    for idx in ([0, 1], [5, 2, 7]):
        got, want = port.gather(idx), jax_ds.gather(idx)
        np.testing.assert_array_equal(got["data"], want["data"])


@pytest.mark.parametrize("name", sorted(jax_transforms))
def test_each_transform_matches_jax(name):
    x = np.random.default_rng(0).normal(size=(2, 32, 40)).astype(
        np.float32)
    got = two_dim_transforms[name](p=1.0)(x, np.random.default_rng(1))
    want = jax_transforms[name](p=1.0)(x, np.random.default_rng(1))
    assert got.shape == x.shape
    np.testing.assert_array_equal(got, want)
    # p = 0 leaves the image alone and draws once
    rng = np.random.default_rng(2)
    assert two_dim_transforms[name](p=0.0)(x, rng) is x


def _conf(cohort, tmp_path, **over):
    return dict(
        data_path=cohort["data_path"], cohort_file=cohort["cohort_file"],
        experiment_num=1, network="cnn_linear_2d",
        dataset_type="unpadded_centered_sequences", n_sub_batches=4,
        kfolds=2, batch_size=2, with_fft=True, dp_devices=1,
        results_dir=str(tmp_path), seed=7, **over)


def test_jax_test_split_lacks_fft_channels(synthetic_cohort, tmp_path):
    """The JAX package's fault: its test split of a with_fft run has one
    channel, which gather broadcasts against three channels' scaling."""
    trainer = jloop.Trainer(JaxConfiguration(
        overrides=_conf(synthetic_cohort, tmp_path)), verbose=False)
    train, test = trainer.get_base_datasets()
    assert train.images.shape[1] == 3 and test.images.shape[1] == 1
    batch = test.gather(test.current_indices()[:2])["data"]
    mu, std = train.scaling_for_current_fold()
    flow = test.images[test.current_indices()[:2]]
    np.testing.assert_allclose(
        batch, (flow - mu[None, :, None, None]) / std[None, :, None, None],
        rtol=1e-6)
    assert batch.shape[1] == 3


def test_port_test_split_has_train_channels(synthetic_cohort, tmp_path):
    trainer = tloop.Trainer(Configuration(overrides=_conf(
        synthetic_cohort, tmp_path)), device="cpu", verbose=False)
    train, test = trainer.get_base_datasets()
    assert test.images.shape[1] == train.images.shape[1] == 3
    np.testing.assert_array_equal(test.images, train.images)
    assert trainer.in_channels == 3
    assert trainer.conf.base_network == "densenet18_2d"
    batch = test.gather(test.current_indices()[:2])["data"]
    assert batch.shape == (2, 3, 224, 224)


def test_reload_dataset_per_epoch_is_read_by_nothing(synthetic_cohort,
                                                     tmp_path):
    """Three row-mix experiment files set it; only the JAX package's
    generator writes it, and the port's datasets are the same with it."""
    readers = []
    for base, _, files in os.walk(os.path.join(ROOT, "deepards_tpu")):
        for f in files:
            if f.endswith(".py") and "reload_dataset_per_epoch" in open(
                    os.path.join(base, f)).read():
                readers.append(f)
    assert readers == ["generate_experiments.py"]
    images = []
    for over in ({}, {"reload_dataset_per_epoch": True}):
        trainer = tloop.Trainer(Configuration(overrides=_conf(
            synthetic_cohort, tmp_path, row_mix=True, **over)),
            device="cpu", verbose=False)
        train, _ = trainer.get_base_datasets()
        images.append(train.mixed_images)
    np.testing.assert_array_equal(*images)
