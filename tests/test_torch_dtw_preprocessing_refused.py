"""``--perform-dtw-preprocessing`` where the JAX package's run fails,
and the ProtoPNet trainer, where it works.

Where the JAX run fails the port refuses the option by name, and each
failure is shown here: the regressor's run, and the siamese and detector
trainers, save no predictions by hour (``pred_to_hour_frame`` is never
set); a 2D network's test split, ``ImgARDSDataset``, has no window cache;
a per-breath head's rows repeat each window's index, which the expansion
cannot take.  The ProtoPNet trainer's JAX run saves predictions by hour:
the port's run writes the frames of its last predictions.
"""
import inspect

import numpy as np
import pandas as pd
import pytest
import torch
from test_torch_dtw_preprocessing import views
from test_torch_dtw_preprocessing_trainers import (
    assert_frames_of_last_predictions,
)
from test_torch_patient_gradcam import save_cohort

import chip_smoke
from deepards_tpu.cli import train as jtrain
from deepards_tpu.data.img_dataset import ImgARDSDataset as JaxImages
from deepards_tpu.eval import plots as jplots
from deepards_tpu.eval.metrics import DeepARDSResults as JaxResults
from deepards_tpu.train import detector_trainer as jdetector
from deepards_tpu.train import siamese_trainer as jsiamese
from deepards_tpu_torch.config.config import Configuration
from deepards_tpu_torch.train.loop import make_trainer

# parallel test workers share the cores: one torch thread each
torch.set_num_threads(1)


def test_protopnet_trainer_writes_frames(synthetic_cohort, tmp_path,
                                         monkeypatch):
    monkeypatch.chdir(tmp_path)
    assert_frames_of_last_predictions(
        synthetic_cohort, tmp_path, ["--network", "protopnet"]
        + chip_smoke.CONFIG5_CUT[2:] + ["--epochs", "2"])


REFUSED = {
    "cnn_regressor": chip_smoke.CONFIG3_FLAGS,
    "siamese_cnn_linear": chip_smoke.SIAMESE_FLAGS["siamese_cnn_linear"],
    "cnn_linear_2d": chip_smoke.TWO_D_FLAGS["cnn_linear_2d"],
    "retinanet_2d": chip_smoke.CONFIG_FLAGS["retinanet_2d"],
    "cnn_lstm": chip_smoke.CONFIG4_FLAGS,
    "cnn_single_breath_linear": chip_smoke.CONFIG1_FLAGS + [
        "--network", "cnn_single_breath_linear"],
    "cnn_transformer": chip_smoke.CONFIG1_FLAGS + [
        "--network", "cnn_transformer"],
}


@pytest.mark.parametrize("name", sorted(REFUSED))
def test_port_refuses_where_the_jax_run_fails(synthetic_cohort, tmp_path,
                                              name):
    from deepards_tpu_torch.cli.train import build_parser

    conf = Configuration(build_parser().parse_args(
        REFUSED[name] + ["--data-path", synthetic_cohort["data_path"],
                         "--perform-dtw-preprocessing"]))
    with pytest.raises(NotImplementedError,
                       match="perform_dtw_preprocessing with " + name):
        make_trainer(conf, device="cpu")


def test_jax_regressor_run_fails(synthetic_cohort, tmp_path, monkeypatch):
    """Config 3's JAX run trains and tests, then fails in the hook."""
    monkeypatch.chdir(tmp_path)
    flags = chip_smoke.CONFIG3_FLAGS + [
        "--data-path", synthetic_cohort["data_path"], "--cohort-file",
        synthetic_cohort["cohort_file"], "--epochs", "1",
        "--results-dir", str(tmp_path / "r"), "--perform-dtw-preprocessing"]
    with pytest.raises(AttributeError, match="pred_to_hour_frame"):
        jtrain.main(flags)


@pytest.mark.parametrize("cls", [jsiamese.SiameseTrainer,
                                 jdetector.DetectorTrainer])
def test_jax_siamese_and_detector_save_no_predictions_by_hour(cls):
    """Their evals record through their own methods, never
    ``record_classifier_results`` (the one caller of
    ``save_predictions_by_hour``), so the hook meets results without
    ``pred_to_hour_frame``."""
    assert "record_classifier_results" not in inspect.getsource(cls)
    with pytest.raises(AttributeError, match="pred_to_hour_frame"):
        jplots.perform_dtw_preprocessing(JaxResults("0", None), None)


def test_jax_image_dataset_has_no_window_cache(tmp_path):
    """A 2D network's test split is an ``ImgARDSDataset``."""
    jax_raw, port_raw = views(save_cohort(str(tmp_path), total_kfolds=2),
                              1)
    images = JaxImages(jax_raw)
    frame = pd.DataFrame({"pred": 0, "hour": 0.0, "patient": "7", "y": 0},
                         index=[0])
    with pytest.raises(AttributeError, match="cache"):
        jplots.process_pred_to_hour_for_dtw(frame, images)


def test_jax_per_breath_predictions_fail(tmp_path):
    """A per-breath head's predictions repeat each window's index S times
    (``deepards_tpu/train/loop.py:1322-1327``); the JAX expansion then
    fails."""
    jax_ds, port_ds = views(save_cohort(str(tmp_path), total_kfolds=2), 1)
    truth = jax_ds.get_ground_truth_df()
    s = jax_ds.cache.data.shape[1]
    series = pd.Series(np.zeros(s * len(truth), np.int64),
                       index=np.repeat(truth.index.to_numpy(), s))
    results = JaxResults("0", None)
    hours = {int(i): jax_ds.cache.hours[int(i)] for i in truth.index}
    results.save_predictions_by_hour(truth, series.sort_index(), hours, 1, 0)
    with pytest.raises(ValueError, match="Length of values"):
        jplots.perform_dtw_preprocessing(results, jax_ds,
                                         str(tmp_path / "jax"))
