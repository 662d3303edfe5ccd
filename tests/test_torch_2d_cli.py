"""The 2D experiment files through the port's ``cli.train`` on the CPU,
unchanged (the generated ymls of the JAX package), fold 0 of their 5 on a
synthetic cohort of 10 patients, one epoch (protopnet_2d cut to a warm
epoch and a joint one with a push), each step at full width (224x224
images, densenet18_2d and its variants): every fold trained records
finite losses and its test metrics, a detector its band IoU;
``cli.predict`` scores a cnn_linear_2d checkpoint as the trainer's eval of
it does; the server refuses a 2D network by name; and three of
``chip_smoke.py``'s 2D networks train from its flags with pandas,
scikit-learn, PyYAML and JAX blocked."""
import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from deepards_tpu_torch.cli.predict import main as predict_main
from deepards_tpu_torch.cli.train import main as train_main
from deepards_tpu_torch.data.synthetic import generate_cohort

# parallel test workers share the cores: one torch thread each
torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
GENERATED = os.path.join(ROOT, "deepards_tpu", "config", "experiment_files",
                         "generated")
CUT = ["--epochs", "1", "--only-fold", "0"]
PPNET_CUT = ["--epochs", "2", "--only-fold", "0", "--n-warm-epochs", "1",
             "-pse", "2", "--push-every-n", "1", "--n-push-iters", "1"]


@pytest.fixture(scope="module")
def cohort(tmp_path_factory):
    path = str(tmp_path_factory.mktemp("cohort2d"))
    cohort_file = generate_cohort(path, n_patients=10,
                                  n_breaths_per_patient=230, seed=3,
                                  subdirs=("all_data",))
    return ["--data-path", path, "--cohort-file", cohort_file]


@pytest.mark.parametrize("yml,cut", [
    ("unpadded_centered_nb20_cnn_linear_2d_bs2.yml", CUT),
    ("unpadded_centered_nb20_cnn_linear_2d_bs2_fft_baseline.yml", CUT),
    ("unpadded_centered_nb20_cnn_linear_2d_bs2_only_fft_baseline.yml", CUT),
    ("unpadded_centered_nb20_cnn_linear_2x1d_bs2_all_transforms.yml", CUT),
    ("unpadded_centered_nb20_cnn_linear_2d_bs2_row_mix_reload_per_epoch_"
     "add_fft_real.yml", CUT),
    ("protopnet2d_unpadded_centered.yml", PPNET_CUT),
    ("unpadded_centered_nb20_retinanet_bs2_bbox_baseline.yml", CUT),
    ("unpadded_centered_nb20_frcnn_bs2_bbox_baseline.yml", CUT),
    ("unpadded_centered_nb20_retinanet_2x1d_bs2_bbox_baseline.yml", CUT)],
    ids=["cnn_linear_2d", "add_fft", "only_fft", "2x1d_transforms",
         "row_mix_fft_real", "protopnet_2d", "retinanet_2d",
         "faster_rcnn_2d", "retinanet_2x1d"])
def test_2d_yml_trains(cohort, tmp_path, yml, cut):
    trainer = train_main(["-co", os.path.join(GENERATED, yml), *cohort,
                          "--device", "cpu", "--results-dir",
                          str(tmp_path), *cut])
    meters = trainer.results.reporting.meters
    assert np.isfinite(meters["loss_fold_0"].values).all()
    model = trainer.final_state.model
    assert model.breath_block.conv0.in_channels == trainer.in_channels
    if trainer.spec.kind == "detector":
        for meter in ("band_iou_fold_0", "band_iou_test_fold_0",
                      "test_loss_fold_0"):
            assert len(meters[meter].values) == 1, meter
    else:
        assert meters["test_auc_fold_0"].values
    if "2x1d" in yml:
        assert model.breath_block.block_kernel == (3, 1)


def test_predict_scores_a_2d_checkpoint_as_the_trainer(cohort, tmp_path):
    yml = "unpadded_centered_nb20_cnn_linear_2d_bs2_fft_baseline.yml"
    flags = ["-co", os.path.join(GENERATED, yml), *cohort, "--device", "cpu",
             "--only-fold", "0"]
    train_main(flags + ["--epochs", "1", "--save-model", "m.pt",
                        "--saved-models-dir", str(tmp_path / "models"),
                        "--results-dir", str(tmp_path / "r1")])
    checkpoint = str(tmp_path / "models" / "m-fold0")
    rows, votes = predict_main([
        "--checkpoint", checkpoint, "-o", str(tmp_path / "p.csv"),
        "--votes-output", str(tmp_path / "v.json")] + flags)
    evaluated = train_main(flags + [
        "--load-checkpoint", checkpoint, "--no-train", "--epochs", "1",
        "--results-dir", str(tmp_path / "r2")])
    logits = torch.as_tensor(evaluated.last_eval["logits"])
    want = torch.softmax(logits.double(), dim=-1).numpy()
    got = np.array([[r["prob_other"], r["prob_ards"]] for r in rows])
    assert [r["window_index"] for r in rows] == \
        evaluated.last_eval["index"].tolist()
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=0)
    assert votes and {v["patient"] for v in votes} == {
        r["patient"] for r in rows}


def test_serve_refuses_a_2d_network():
    from deepards_tpu_torch.cli.serve import InferenceEngine

    with pytest.raises(ValueError, match="2D network"):
        InferenceEngine(None, network="cnn_linear_2d",
                        base_network="densenet18_2d", device="cpu")


_TWO_D_WITHOUT = r"""
import json, sys
for blocked in ("pandas", "sklearn", "yaml", "jax", "deepards_tpu"):
    sys.modules[blocked] = None  # any import of them raises ImportError
import torch
torch.set_num_threads(1)
import chip_smoke
from deepards_tpu_torch.cli.train import main
from deepards_tpu_torch.data.synthetic import generate_cohort

work = sys.argv[1]
cohort = generate_cohort(work + "/cohort", n_patients=10,
                         n_breaths_per_patient=200, seed=3)
small = ["--data-path", work + "/cohort", "--cohort-file", cohort,
         "--epochs", "1", "--only-fold", "0", "--device", "cpu",
         "--results-dir", work + "/results"]
report = {}
for name in ("cnn_linear_2x1d", "protopnet_2d", "retinanet_2d"):
    trainer = main(chip_smoke.CONFIG_FLAGS[name] + small)
    report[name] = sorted(k for k in trainer.results.reporting.meters
                          if k.endswith("_fold_0"))
print(json.dumps(report))
"""


def test_2d_networks_train_without_pandas_sklearn_or_yaml(tmp_path):
    """One epoch of fold 0 of three of chip_smoke.py's 2D networks from
    its flags (the 2x1d with kernel 11 and its transforms, protopnet_2d
    with its transforms, the detector) at full width, with pandas,
    scikit-learn, PyYAML, JAX and deepards_tpu blocked."""
    out = subprocess.run(
        [sys.executable, "-c", _TWO_D_WITHOUT, str(tmp_path)], cwd=ROOT,
        env={**os.environ, "PYTHONPATH": ROOT},
        capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-3000:]
    report = json.loads(out.stdout.strip().splitlines()[-1])
    assert "test_auc_fold_0" in report["cnn_linear_2x1d"]
    assert "sep_loss_fold_0" in report["protopnet_2d"]
    assert {"band_iou_fold_0", "band_iou_test_fold_0"} <= set(
        report["retinanet_2d"])
