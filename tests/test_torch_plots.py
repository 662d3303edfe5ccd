"""The disease-evolution drawings (``eval/plots.py``) and the trainer's
plot options on the CPU against the JAX package.

What matplotlib is asked to draw is recorded on both sides
(``tests/torch_drawings.py``): the same PNG paths, the same calls with
the same arrays.  On the seeded 4-patient cohort of
``test_torch_patient_gradcam.py`` (S = 3, no folds), drawn predictions and
patient rows: each patient's hourly plot with its DTW frame over it, and
the tiled TP/TN/FP/FN grids; the ``.npz`` beside each PNG holds the bars
drawn.  Whole runs of each package with ``--plot-dtw-with-disease`` and
``--plot-tiled-disease-evol`` (the shared synthetic cohort, S = 4, 1
epoch, the port from the JAX package's init, dropout off): the same
drawings, DTW within rtol 1e-6.  Each PNG stage is refused by name on
the card and without matplotlib, its ``.npz`` still written; the plot
options are refused where the JAX run fails (no predictions by hour),
and ``--plot-pt-dtw-by-minute``, read by nothing, always.
"""
import glob
import os
import sys
from types import SimpleNamespace

import numpy as np
import pandas as pd
import pytest
import torch
from test_torch_dtw_preprocessing import prediction_rows
from test_torch_patient_gradcam import save_cohort
from test_torch_train_jax_runs import _jax_run, _port_run
from torch_drawings import assert_same_drawings, record

import chip_smoke
from deepards_tpu.data.dataset import ARDSRawDataset as JaxDataset
from deepards_tpu.eval import plots as jplots
from deepards_tpu.eval.metrics import DeepARDSResults as JaxResults
from deepards_tpu_torch.cli.train import build_parser
from deepards_tpu_torch.config.config import Configuration
from deepards_tpu_torch.data.dataset import ARDSRawDataset
from deepards_tpu_torch.eval import plots
from deepards_tpu_torch.train.loop import make_trainer

torch.set_num_threads(1)


@pytest.fixture(scope="module")
def cohort(tmp_path_factory):
    return save_cohort(str(tmp_path_factory.mktemp("plots")))


def patient_rows(dataset, seed=0):
    """Two epochs of patient rows of ``dataset``'s patients with drawn
    predictions (every TP/TN/FP/FN cell filled at the last), as the
    port's rows and the JAX package's frame."""
    truth = dataset.get_ground_truth()
    rng = np.random.default_rng(seed)
    rows = []
    for epoch in (1, 2):
        for k, pt in enumerate(truth.patients()):
            patho = int(truth.y[list(truth.patient).index(pt)])
            pred = int(rng.integers(0, 2)) if epoch == 1 else (
                patho if k < 2 else 1 - patho)
            rows.append({"patient": str(pt), "patho": patho,
                         "prediction": pred, "epoch_num": epoch})
    return rows, pd.DataFrame(rows)


def _drawings(monkeypatch, root, draw):
    os.makedirs(root, exist_ok=True)
    drawn = record(monkeypatch, root)
    draw(str(root))
    return drawn


def whole(path):
    """(JAX, port) views of all the saved windows."""
    return JaxDataset.from_pickle(path), ARDSRawDataset.from_pickle(path)


def test_drawings_match_jax(cohort, tmp_path, monkeypatch):
    jax_ds, port_ds = whole(cohort)
    rows, frame = prediction_rows(port_ds, seed=3)
    results, results_frame = patient_rows(port_ds)
    want_dtw = jplots.perform_dtw_preprocessing(
        SimpleNamespace(pred_to_hour_frame=frame), jax_ds,
        str(tmp_path / "jcache"))
    got_dtw = plots.perform_dtw_preprocessing(
        SimpleNamespace(pred_to_hour_frame=rows), port_ds,
        str(tmp_path / "pcache"), device="cpu")
    jres = SimpleNamespace(pred_to_hour_frame=frame, results=results_frame)
    pres = SimpleNamespace(pred_to_hour_frame=rows, results=results)

    def jax_draw(root):
        jplots.perform_hourly_patient_plot(jres, root, dtw_frames=want_dtw)
        jplots.plot_tiled_disease_evol(jres, None, root + "/tiled.png")

    def port_draw(root):
        assert len(plots.perform_hourly_patient_plot(
            pres, root, dtw_frames=got_dtw)) == 4
        assert len(plots.plot_tiled_disease_evol(
            pres, root + "/tiled.png")) == 4

    want = _drawings(monkeypatch, tmp_path / "jax", jax_draw)
    got = _drawings(monkeypatch, tmp_path / "port", port_draw)
    assert sorted(got) == sorted(
        ["7.png", "12.png", "3.png", "05.png", "tiled_TP.png",
         "tiled_TN.png", "tiled_FP.png", "tiled_FN.png"])
    assert_same_drawings(got, want)
    # the arrays behind each figure
    for pt in ("7", "12", "3", "05"):
        with np.load(str(tmp_path / "port" / (pt + ".npz"))) as z:
            bars = got[pt + ".png"][0][0][1][1]
            np.testing.assert_array_equal(np.nan_to_num(z["fracs"]), bars)
            assert "dtw" in z.files
    with np.load(str(tmp_path / "port" / "tiled_FP.npz")) as z:
        assert z["fracs"].shape == (1, 24) and len(z["patients"]) == 1


@pytest.mark.parametrize("flag", ["--plot-dtw-with-disease",
                                  "--plot-tiled-disease-evol"])
def test_trainer_plots_match_jax(synthetic_cohort, tmp_path, monkeypatch,
                                 flag):
    option = flag[2:].replace("-", "_")
    over = {option: True, "epochs": 1}
    for side in ("jax", "port"):
        os.makedirs(tmp_path / side)
    monkeypatch.chdir(tmp_path / "jax")
    want = record(monkeypatch, tmp_path / "jax")
    jres, inits, _ = _jax_run(synthetic_cohort, tmp_path / "jax", **over)
    monkeypatch.chdir(tmp_path / "port")
    got = record(monkeypatch, tmp_path / "port")
    port, _ = _port_run(synthetic_cohort, tmp_path / "port", inits, **over)
    assert port.results == jres.results.to_dict(orient="records")
    assert_same_drawings(got, want)
    npz = sorted(os.path.relpath(p, tmp_path / "port") for p in glob.glob(
        str(tmp_path / "port" / "prediction_plots" / "*.npz")))
    assert npz == sorted(p[:-4] + ".npz" for p in got)
    if option == "plot_dtw_with_disease":
        assert glob.glob(str(tmp_path / "port" / "dtw_cache" / "*"))


@pytest.mark.parametrize("how", ["card", "no matplotlib"])
def test_png_stages_refused(cohort, tmp_path, monkeypatch, capsys, how):
    _, port_ds = whole(cohort)
    rows, _ = prediction_rows(port_ds)
    results, _ = patient_rows(port_ds)
    pres = SimpleNamespace(pred_to_hour_frame=rows, results=results)
    device = "cpu"
    if how == "card":
        device = "cuda"  # a refusal reads the device's type, not a card
    else:
        monkeypatch.setitem(sys.modules, "matplotlib", None)
    root = str(tmp_path / "out")
    assert plots.perform_hourly_patient_plot(pres, root,
                                             device=device) == []
    assert plots.plot_tiled_disease_evol(pres, root + "/tiled.png",
                                         device=device) == []
    out = capsys.readouterr().out
    reason = ("drawn on the CPU host only" if how == "card"
              else "matplotlib is missing")
    assert out.count("refused: " + reason) == 8
    assert "PNG stage 7.png refused" in out
    assert not glob.glob(root + "/*.png")
    assert len(glob.glob(root + "/*.npz")) == 8


def test_jax_plots_need_predictions_by_hour(tmp_path, monkeypatch):
    """The JAX drawings read ``pred_to_hour_frame``, which runs without
    predictions by hour never set."""
    monkeypatch.chdir(tmp_path)  # they make prediction_plots first
    for draw in (jplots.perform_hourly_patient_plot,
                 jplots.plot_tiled_disease_evol):
        with pytest.raises(AttributeError, match="pred_to_hour_frame"):
            draw(JaxResults("0", None))


@pytest.mark.parametrize("name,flags,refused", [
    ("cnn_regressor", chip_smoke.CONFIG3_FLAGS, True),
    ("siamese_cnn_linear", chip_smoke.SIAMESE_FLAGS["siamese_cnn_linear"],
     True),
    ("retinanet_2d", chip_smoke.CONFIG_FLAGS["retinanet_2d"], True),
    ("cnn_linear_2d", chip_smoke.TWO_D_FLAGS["cnn_linear_2d"], False),
    ("cnn_single_breath_linear", chip_smoke.CONFIG1_FLAGS + [
        "--network", "cnn_single_breath_linear"], False),
])
def test_plot_options_refused_where_jax_fails(synthetic_cohort, name, flags,
                                              refused):
    """No predictions by hour: refused by name; a 2D network or a
    per-breath head draws its plots (only its DTW is refused)."""
    conf = Configuration(build_parser().parse_args(flags + [
        "--data-path", synthetic_cohort["data_path"],
        "--plot-untiled-disease-evol", "--plot-tiled-disease-evol"]))
    if refused:
        with pytest.raises(NotImplementedError, match=(
                "plot_untiled_disease_evol, plot_tiled_disease_evol with "
                + name)):
            make_trainer(conf, device="cpu")
    else:
        make_trainer(conf, device="cpu")
        conf.conf["plot_dtw_with_disease"] = True
        with pytest.raises(NotImplementedError,
                           match="plot_dtw_with_disease with " + name):
            make_trainer(conf, device="cpu")


def test_plot_pt_dtw_by_minute_is_refused(synthetic_cohort):
    conf = Configuration(build_parser().parse_args(
        chip_smoke.CONFIG1_FLAGS + ["--data-path",
                                    synthetic_cohort["data_path"],
                                    "--plot-pt-dtw-by-minute", "5"]))
    with pytest.raises(ValueError, match="read by nothing"):
        make_trainer(conf, device="cpu")
