"""The port stands alone: it imports no JAX and nothing of deepards_tpu,
and its entry points run on the card unless asked for the CPU."""
import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

_IMPORT_ALL = r"""
import json, pkgutil, sys
for blocked in ("jax", "jaxlib", "flax", "optax", "orbax"):
    sys.modules[blocked] = None  # any import of them raises ImportError
import deepards_tpu_torch
modules = ["deepards_tpu_torch"]
for info in pkgutil.walk_packages(deepards_tpu_torch.__path__,
                                  "deepards_tpu_torch."):
    __import__(info.name)
    modules.append(info.name)
import chip_smoke
loaded = sorted(k for k, v in sys.modules.items() if v is not None)
print(json.dumps({"modules": modules, "loaded": loaded}))
"""


def test_port_imports_no_jax_and_no_reference_package():
    out = subprocess.run(
        [sys.executable, "-c", _IMPORT_ALL], cwd=ROOT, env={
            **os.environ, "PYTHONPATH": ROOT},
        capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    report = json.loads(out.stdout.strip().splitlines()[-1])
    assert {"deepards_tpu_torch.cli.serve", "deepards_tpu_torch.ops.dtw",
            "deepards_tpu_torch.dtw.lib",
            "deepards_tpu_torch.transplant",
            "deepards_tpu_torch.cli.train",
            "deepards_tpu_torch.cli.predict",
            "deepards_tpu_torch.cli.sim_dissim",
            "deepards_tpu_torch.cli.perform_data_splitting",
            "deepards_tpu_torch.cli.analysis",
            "deepards_tpu_torch.config.splitfile",
            "deepards_tpu_torch.dtw.kmedoids",
            "deepards_tpu_torch.data.augment",
            "deepards_tpu_torch.config.config",
            "deepards_tpu_torch.data.breath",
            "deepards_tpu_torch.data.correlation",
            "deepards_tpu_torch.data.dataset",
            "deepards_tpu_torch.data.pipeline",
            "deepards_tpu_torch.data.reader",
            "deepards_tpu_torch.data.sampling",
            "deepards_tpu_torch.data.synthetic",
            "deepards_tpu_torch.data.windowing",
            "deepards_tpu_torch.eval.metrics",
            "deepards_tpu_torch.models.recurrent",
            "deepards_tpu_torch.models.resnet1d",
            "deepards_tpu_torch.train.checkpoint",
            "deepards_tpu_torch.train.loader",
            "deepards_tpu_torch.train.loop",
            "deepards_tpu_torch.train.losses",
            "deepards_tpu_torch.train.steps",
            "deepards_tpu_torch.train.parallel_folds",
            "deepards_tpu_torch.train.protopnet_trainer",
            "deepards_tpu_torch.models.protopnet1d",
            "deepards_tpu_torch.explain.gradcam",
            "deepards_tpu_torch.explain.patient_gradcam",
            "deepards_tpu_torch.explain.dtw_gradcam",
            "deepards_tpu_torch.explain.prototypes",
            "deepards_tpu_torch.explain.cam_analytics",
            "deepards_tpu_torch.explain.explainer_comparison",
            "deepards_tpu_torch.cli.patient_gradcam",
            "deepards_tpu_torch.cli.protopnet_analysis",
            "deepards_tpu_torch.models.heads",
            "deepards_tpu_torch.models.transformer",
            "deepards_tpu_torch.models.nested",
            "deepards_tpu_torch.train.nested_trainer",
            "deepards_tpu_torch.data.img_dataset",
            "deepards_tpu_torch.data.img_transforms",
            "deepards_tpu_torch.models.densenet2d",
            "deepards_tpu_torch.models.protopnet2d",
            "deepards_tpu_torch.models.detection2d",
            "deepards_tpu_torch.train.detector_trainer",
            "deepards_tpu_torch.models.siamese",
            "deepards_tpu_torch.models.vgg1d",
            "deepards_tpu_torch.models.senet1d",
            "deepards_tpu_torch.models.unet1d",
            "deepards_tpu_torch.models.autoencoder_cnn",
            "deepards_tpu_torch.data.siamese_dataset",
            "deepards_tpu_torch.train.siamese_trainer",
            "deepards_tpu_torch.eval.plots",
            "deepards_tpu_torch.explain.frequency_analytics",
            "deepards_tpu_torch.cli.cam_analytics",
            "deepards_tpu_torch.cli.evaluate",
            "deepards_tpu_torch.cli.mean_metrics",
            "deepards_tpu_torch.cli.visualize_results",
            "deepards_tpu_torch.cli.find_all_experiments",
            "deepards_tpu_torch.config.yamlfile",
            "deepards_tpu_torch.config.generate_experiments",
            "deepards_tpu_torch.cli.run_experiments",
            "deepards_tpu_torch.cli.registry_sweep",
            "deepards_tpu_torch.data.legacy_pickle",
            "deepards_tpu_torch.eval.legacy_results",
            "deepards_tpu_torch.cli.create_datasets",
            "deepards_tpu_torch.cli.anonymize_cohort",
            "deepards_tpu_torch.utils.profiling",
            "deepards_tpu_torch.utils.figures",
            "deepards_tpu_torch.parallel.mesh",
            "deepards_tpu_torch.cli.launch_distributed",
            "deepards_tpu_torch.cli.dataset_figs",
            "deepards_tpu_torch.cli.dl_vs_rf"} <= set(report["modules"])
    forbidden = [
        name for name in report["loaded"]
        if name == "deepards_tpu" or name.startswith("deepards_tpu.")
        or name.split(".")[0] in ("jax", "jaxlib", "flax", "optax", "orbax",
                                  "pandas", "yaml", "sklearn", "matplotlib")
    ]
    assert forbidden == []


_TRAIN_WITHOUT = r"""
import sys
for blocked in ("pandas", "sklearn", "yaml", "jax", "deepards_tpu"):
    sys.modules[blocked] = None  # any import of them raises ImportError
import torch
torch.set_num_threads(1)
import chip_smoke
from deepards_tpu_torch.cli.train import main
from deepards_tpu_torch.data.synthetic import generate_cohort

work = sys.argv[1]
cohort = generate_cohort(work + "/cohort", n_patients=4,
                         n_breaths_per_patient=80, seed=3)
flags = chip_smoke.CONFIG1_FLAGS + [
    "--data-path", work + "/cohort", "--cohort-file", cohort,
    "--n-sub-batches", "4", "--batch-size", "8", "--kfolds", "2",
    "--only-fold", "0", "--epochs", "1", "--device", "cpu",
    "--results-dir", work + "/results", "--transforms", "ie_ww",
    "--butter-low", "0.5"]
trainer = main(flags + ["--save-model", "m.pt",
                        "--saved-models-dir", work + "/models"])
assert trainer.results.get_meter("loss", 0).values
assert len(trainer.results.get_meter("test_auc", 0).values) == 1
from deepards_tpu_torch.cli.predict import main as predict
rows, votes = predict(["--checkpoint", work + "/models/m-fold0",
                       "-o", work + "/p.csv", "--votes-output",
                       work + "/v.json"] + flags)
assert rows and votes
"""


def test_training_needs_no_pandas_sklearn_or_yaml(tmp_path):
    """The path chip_smoke.py drives, a 1-fold 1-epoch CPU training from
    config 1's flags with augmentation and the Butterworth filter, then
    ``cli.predict`` on its checkpoint, runs with pandas, scikit-learn and
    PyYAML blocked."""
    out = subprocess.run(
        [sys.executable, "-c", _TRAIN_WITHOUT, str(tmp_path)], cwd=ROOT,
        env={**os.environ, "PYTHONPATH": ROOT},
        capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-3000:]
    assert (tmp_path / "models" / "m-fold0.scaling.json").exists()
    assert (tmp_path / "p.csv").exists() and (tmp_path / "v.json").exists()


_CONFIGS_WITHOUT = r"""
import json, sys
for blocked in ("pandas", "sklearn", "yaml", "jax", "deepards_tpu"):
    sys.modules[blocked] = None  # any import of them raises ImportError
import torch
torch.set_num_threads(1)
import chip_smoke
from deepards_tpu_torch.cli.predict import main as predict
from deepards_tpu_torch.cli.train import main
from deepards_tpu_torch.data.synthetic import generate_cohort

work = sys.argv[1]
cohort = generate_cohort(work + "/cohort", n_patients=4,
                         n_breaths_per_patient=80, seed=3,
                         subdirs=("all_data", "aim1_70_30_training",
                                  "aim1_70_30_testing"))
small = ["--data-path", work + "/cohort", "--cohort-file", cohort,
         "--epochs", "1", "--device", "cpu", "--results-dir",
         work + "/results", "--initial-planes", "8"]
folds = ["--n-sub-batches", "4", "--batch-size", "8", "--kfolds", "2",
         "--only-fold", "0"]
report = {}
for name, extra in (("config2", folds), ("config3", []),
                    ("config4", folds)):
    flags = chip_smoke.CONFIG_FLAGS[name] + small + extra
    trainer = main(flags + ["--save-model", name + ".pt",
                            "--saved-models-dir", work + "/models"])
    report[name] = {k: len(v.values) for k, v in
                    trainer.results.reporting.meters.items()
                    if k.startswith(("loss_fold", "test_auc", "test_r2"))}
rows, votes = predict(["--checkpoint", work + "/models/config4-fold0",
                       "-o", work + "/p.csv", "--votes-output",
                       work + "/v.json"] + chip_smoke.CONFIG4_FLAGS + small
                      + folds)
report["predict_rows"] = len(rows)
for extra in (["--unshuffled"], ["--parallel-folds"]):
    trainer = main(chip_smoke.CONFIG4_FLAGS + small + folds + extra)
    report[extra[0]] = [len(trainer.results.get_meter("loss", f).values)
                        for f in (0, 1)]
print(json.dumps(report))
"""


def test_configs_2_3_4_train_without_pandas_sklearn_or_yaml(tmp_path):
    """One epoch of each of configs 2, 3 and 4 from chip_smoke.py's flags
    (narrowed: resnet18 at 8 initial planes, S = 4 for the k-fold
    configs) and ``cli.predict`` on config 4's checkpoint, with pandas,
    scikit-learn, PyYAML, JAX and deepards_tpu blocked; config 4 with
    ``--unshuffled`` (its stateful fold, fold 0) and ``--parallel-folds``
    (both folds at once) trains too."""
    out = subprocess.run(
        [sys.executable, "-c", _CONFIGS_WITHOUT, str(tmp_path)], cwd=ROOT,
        env={**os.environ, "PYTHONPATH": ROOT},
        capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-3000:]
    report = json.loads(out.stdout.strip().splitlines()[-1])
    assert report["config2"]["loss_fold_0"] and \
        report["config2"]["test_auc_fold_0"] == 1
    assert report["config3"]["test_r2_fold_0"] == 1
    assert report["config4"]["test_auc_fold_0"] == 1
    assert report["predict_rows"] > 0
    unshuffled, parallel = report["--unshuffled"], report["--parallel-folds"]
    assert unshuffled[0] > 0 and unshuffled[1] == 0
    assert parallel[0] > 0 and parallel[0] == parallel[1]
    assert (tmp_path / "models" / "config3.scaling.json").exists()


_SEQUENCE_WITHOUT = r"""
import json, sys
for blocked in ("pandas", "sklearn", "yaml", "jax", "deepards_tpu"):
    sys.modules[blocked] = None  # any import of them raises ImportError
import torch
torch.set_num_threads(1)
import chip_smoke
from deepards_tpu_torch.cli.predict import main as predict
from deepards_tpu_torch.cli.train import main
from deepards_tpu_torch.data.synthetic import generate_cohort

work = sys.argv[1]
cohort = generate_cohort(work + "/cohort", n_patients=4,
                         n_breaths_per_patient=80, seed=3)
small = ["--data-path", work + "/cohort", "--cohort-file", cohort,
         "--epochs", "1", "--device", "cpu", "--results-dir",
         work + "/results", "--initial-planes", "8", "--base-network",
         "resnet18", "--n-sub-batches", "4", "--batch-size", "8",
         "--kfolds", "2", "--only-fold", "0"]
report = {}
for name in chip_smoke.SEQUENCE_FLAGS:
    trainer = main(chip_smoke.CONFIG_FLAGS[name] + small + [
        "--save-model", name + ".pt", "--saved-models-dir",
        work + "/models"])
    report[name] = [len(trainer.results.get_meter(m, 0).values)
                    for m in ("loss", "test_auc")]
rows, votes = predict(["--checkpoint",
                       work + "/models/cnn_to_nested_lstm-fold0",
                       "-o", work + "/p.csv", "--votes-output",
                       work + "/v.json"]
                      + chip_smoke.CONFIG_FLAGS["cnn_to_nested_lstm"]
                      + small)
report["predict_rows"] = len(rows)
print(json.dumps(report))
"""


def test_sequence_networks_train_without_pandas_sklearn_or_yaml(tmp_path):
    """One epoch of fold 0 of every network of chip_smoke.py's sequence
    phase from its flags (narrowed: resnet18 at 8 initial planes, S = 4)
    and ``cli.predict`` on a nested network's checkpoint, with pandas,
    scikit-learn, PyYAML, JAX and deepards_tpu blocked."""
    out = subprocess.run(
        [sys.executable, "-c", _SEQUENCE_WITHOUT, str(tmp_path)], cwd=ROOT,
        env={**os.environ, "PYTHONPATH": ROOT},
        capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-3000:]
    report = json.loads(out.stdout.strip().splitlines()[-1])
    assert report.pop("predict_rows") > 0
    assert len(report) == 11
    for name, (losses, aucs) in report.items():
        assert losses > 0 and aucs == 1, name


_CONFIGS_5_7_WITHOUT = r"""
import json, sys
for blocked in ("pandas", "sklearn", "yaml", "jax", "deepards_tpu"):
    sys.modules[blocked] = None  # any import of them raises ImportError
import numpy as np
import torch
torch.set_num_threads(1)
import chip_smoke
from deepards_tpu_torch.cli.train import main
from deepards_tpu_torch.data.synthetic import generate_cohort
from deepards_tpu_torch.explain.gradcam import MaxMinNormCam

work = sys.argv[1]
cohort = generate_cohort(work + "/cohort", n_patients=4,
                         n_breaths_per_patient=80, seed=3)
small = ["--data-path", work + "/cohort", "--cohort-file", cohort,
         "--device", "cpu", "--results-dir", work + "/results",
         "--n-sub-batches", "4", "--batch-size", "8", "--kfolds", "2"]
report = {}
ppnet = main(chip_smoke.CONFIG5_FLAGS + small + chip_smoke.CONFIG5_CUT
             + ["--only-fold", "0", "--save-model", "c5.pt",
                "--saved-models-dir", work + "/models"])
report["config5"] = {
    "pushes": len(ppnet.push_infos),
    "steps": len(ppnet.results.get_meter("loss", 0).values),
    "aucs": len(ppnet.results.get_meter("test_auc", 0).values)}
parallel = main(chip_smoke.CONFIG_FLAGS["config7"] + small
                + ["--epochs", "1", "--save-model", "c7.pt",
                   "--saved-models-dir", work + "/models"])
report["config7"] = [len(parallel.results.get_meter("test_auc", f).values)
                     for f in (0, 1)]
from deepards_tpu_torch.models import densenet1d, heads
cam = MaxMinNormCam(heads.CNNLinearNetwork(densenet1d.densenet18(), 4))
cams, _ = cam.generate_read_cams_batch(
    np.random.default_rng(0).normal(size=(2, 4, 1, 224)), [0, 1])
report["cams"] = list(cams.shape)
print(json.dumps(report))
"""


def test_configs_5_and_7_train_without_pandas_sklearn_or_yaml(tmp_path):
    """Config 5 (ProtoPNet, fold 0, chip_smoke.py's cut schedule: every
    stage and two pushes) and config 7 (``--parallel-folds``, both folds,
    one epoch) through ``cli.train``, and a GradCAM batch, from
    chip_smoke.py's flags at S = 4, with pandas, scikit-learn, PyYAML, JAX
    and deepards_tpu blocked."""
    out = subprocess.run(
        [sys.executable, "-c", _CONFIGS_5_7_WITHOUT, str(tmp_path)],
        cwd=ROOT, env={**os.environ, "PYTHONPATH": ROOT},
        capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-3000:]
    report = json.loads(out.stdout.strip().splitlines()[-1])
    assert report["config5"]["pushes"] == 2
    assert report["config5"]["aucs"] == 3 and report["config5"]["steps"]
    assert report["config7"] == [1, 1]
    assert report["cams"] == [2, 4, 7]
    assert (tmp_path / "models" / "c7-fold1.scaling.json").exists()
    assert (tmp_path / "models" / "c5-fold0").exists()


_HETERO_WITHOUT = r"""
import sys
for blocked in ("pandas", "sklearn", "yaml", "jax", "deepards_tpu"):
    sys.modules[blocked] = None  # any import of them raises ImportError
import torch
torch.set_num_threads(1)
import chip_smoke
launches = chip_smoke.phase_hetero(sys.argv[1], device="cpu", nb=2,
                                   n_patients=12, n_breaths=60, train_n=4,
                                   test_n=2)
assert launches == 0  # the CPU runs the kernel's plain version
"""


def test_hetero_chain_needs_no_pandas_sklearn_or_yaml(tmp_path):
    """chip_smoke.py's hetero phase on the CPU at a small size:
    ``cli.sim_dissim hetero`` on a saved dataset, ``cli.perform_data_
    splitting preset_file``, a holdout ``cli.train``, ``breakdown`` of its
    results and ``cli.analysis lstm-dtw`` twice (the second from its
    cache), with pandas, scikit-learn, PyYAML, JAX and deepards_tpu
    blocked."""
    out = subprocess.run(
        [sys.executable, "-c", _HETERO_WITHOUT, str(tmp_path)], cwd=ROOT,
        env={**os.environ, "PYTHONPATH": ROOT},
        capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-3000:]
    phase = [json.loads(line) for line in out.stdout.splitlines()
             if line.startswith('{"phase": "hetero"')]
    assert len(phase) == 1 and set(phase[0]["steps"]) == {
        "sim_dissim_hetero", "perform_data_splitting", "train", "breakdown",
        "lstm_dtw", "lstm_dtw_cached"}
    assert (tmp_path / "splits" / "train_sim_test_sim_dissim_split_2.yml"
            ).exists()
    assert os.listdir(tmp_path / "hetero_cohort" / "experiment1" /
                      "train_sim_test_sim_dissim_split_1train" / "raw")


_EXPLAIN_WITHOUT = r"""
import sys
for blocked in ("pandas", "sklearn", "yaml", "jax", "deepards_tpu",
                "matplotlib"):
    sys.modules[blocked] = None  # any import of them raises ImportError
import torch
torch.set_num_threads(1)
import chip_smoke
launches = chip_smoke.phase_explain(sys.argv[1], device="cpu", nb=4,
                                    n_windows=6, other_windows=2,
                                    n_patients=4, kfolds=2)
assert launches == 0  # the CPU runs the kernel's plain version
"""


def test_explain_clis_need_no_pandas_sklearn_yaml_or_matplotlib(tmp_path):
    """chip_smoke.py's explain phase on the CPU at a small size (S = 4, a
    patient of 6 windows): ``cli.patient_gradcam`` (``dtw_clust`` and the
    other six ops) and ``cli.protopnet_analysis`` on seeded checkpoints,
    with pandas, scikit-learn, PyYAML, matplotlib, JAX and deepards_tpu
    blocked."""
    import chip_smoke

    out = subprocess.run(
        [sys.executable, "-c", _EXPLAIN_WITHOUT, str(tmp_path)], cwd=ROOT,
        env={**os.environ, "PYTHONPATH": ROOT},
        capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-3000:]
    phase = [json.loads(line) for line in out.stdout.splitlines()
             if line.startswith('{"phase": "explain"')]
    assert len(phase) == 1
    assert phase[0]["dtw_clust"]["spans"] > 2
    assert set(phase[0]["ops"]) == set(chip_smoke.EXPLAIN_OPS)
    assert phase[0]["protopnet_analysis"]["pane_records"] == 16
    assert (tmp_path / "explain" / "dtw_clust" / "dtw_clustering" /
            "non_ards" / "1" / "elbow.npz").exists()


def test_explain_clis_raise_without_cuda(tmp_path):
    """Both explain CLIs refuse the default device with no card; with
    ``--device cpu`` they run (the test above)."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    from deepards_tpu_torch.cli import patient_gradcam, protopnet_analysis

    with pytest.raises(RuntimeError, match="CUDA"):
        patient_gradcam.main([str(tmp_path / "m.pt"), "-pdp",
                              str(tmp_path / "d.npz"), "--fold", "0",
                              "--ops", "dtw_clust"])
    with pytest.raises(RuntimeError, match="CUDA"):
        protopnet_analysis.main([str(tmp_path / "m.pt"),
                                 "--kfold-from-pickle",
                                 str(tmp_path / "d.npz"), "--kfold-idx",
                                 "0"])


def test_entry_points_raise_without_cuda(tmp_path):
    """With no card, the default device is refused, never replaced."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    from deepards_tpu_torch.cli.analysis import main as analysis_main
    from deepards_tpu_torch.cli.predict import main as predict_main
    from deepards_tpu_torch.cli.serve import InferenceEngine
    from deepards_tpu_torch.cli.train import main as train_main
    from deepards_tpu_torch.config.config import Configuration
    from deepards_tpu_torch.dtw.lib import (
        batched_dtw_pairs,
        find_patient_similarity,
        per_breath_dtw_scores,
    )
    from deepards_tpu_torch.ops.dtw import dtw_batch
    from deepards_tpu_torch.train.loop import Trainer

    a = np.zeros((2, 8), np.float32)
    with pytest.raises(RuntimeError, match="CUDA"):
        InferenceEngine(str(tmp_path / "missing.pt"))
    with pytest.raises(RuntimeError, match="CUDA"):
        dtw_batch(a, a)
    with pytest.raises(RuntimeError, match="CUDA"):
        batched_dtw_pairs(list(a), list(a))
    with pytest.raises(RuntimeError, match="CUDA"):
        per_breath_dtw_scores(list(np.zeros((5, 8), np.float32)))
    with pytest.raises(RuntimeError, match="CUDA"):
        train_main(["--data-path", str(tmp_path)])
    with pytest.raises(RuntimeError, match="CUDA"):
        predict_main(["--checkpoint", str(tmp_path / "missing.pt"),
                      "--data-path", str(tmp_path)])
    with pytest.raises(RuntimeError, match="CUDA"):
        Trainer(Configuration(overrides={"data_path": str(tmp_path)}))
    import chip_smoke

    ds = chip_smoke.cohort_dataset(
        str(tmp_path), np.ones((4, 2, 1, 224), np.float32), [0, 1], 2)
    with pytest.raises(RuntimeError, match="CUDA"):
        find_patient_similarity(ds)
    with pytest.raises(RuntimeError, match="CUDA"):
        analysis_main(["lstm-dtw", "--train-from-pickle",
                       ds.save(str(tmp_path / "ds.npz")), "--cache-dir",
                       str(tmp_path / "cache")])


def test_dtw_cuda_refuses_cpu_tensors():
    """The kernel's wrapper has no CPU fallback: CPU tensors raise."""
    from deepards_tpu_torch.ops.dtw import dtw_cuda

    a = torch.zeros(2, 8)
    n = torch.full((2,), 8, dtype=torch.int32)
    with pytest.raises(ValueError, match="CUDA tensor"):
        dtw_cuda(a, a, n, n)


def test_chip_smoke_counts_kernels_not_annotations():
    """An optimizer's step shows on the profiler's device timeline as a
    user annotation; it is no kernel launch and no kernel time."""
    from types import SimpleNamespace

    from torch.autograd import DeviceType

    import chip_smoke

    kernel = SimpleNamespace(device_type=DeviceType.CUDA,
                             is_user_annotation=False)
    step = SimpleNamespace(device_type=DeviceType.CUDA,
                           is_user_annotation=True)
    host = SimpleNamespace(device_type=DeviceType.CPU,
                           is_user_annotation=False)
    assert chip_smoke.kernel_events([kernel, step, host]) == [kernel]


def test_resolve_device():
    from deepards_tpu_torch.device import resolve_device

    assert resolve_device("cpu") == torch.device("cpu")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError):
            resolve_device(None)


_SIAMESE_WITHOUT = r"""
import json, sys
for blocked in ("pandas", "sklearn", "yaml", "jax", "deepards_tpu"):
    sys.modules[blocked] = None  # any import of them raises ImportError
import torch
torch.set_num_threads(1)
import chip_smoke
from deepards_tpu_torch.cli.predict import main as predict
from deepards_tpu_torch.cli.train import main
from deepards_tpu_torch.data.synthetic import generate_cohort

work = sys.argv[1]
cohort = generate_cohort(work + "/cohort", n_patients=6,
                         n_breaths_per_patient=80, seed=3,
                         subdirs=("all_data", "aim1_70_30_training",
                                  "aim1_70_30_testing"))
small = ["--data-path", work + "/cohort", "--cohort-file", cohort,
         "--epochs", "1", "--device", "cpu", "--results-dir",
         work + "/results", "--n-sub-batches", "4", "--batch-size", "4",
         "--saved-models-dir", work + "/models"]
report = {}
for name in chip_smoke.SIAMESE:
    trainer = main(chip_smoke.CONFIG_FLAGS[name] + small + [
        "--save-model", name + ".pt"])
    report[name] = [len(trainer.results.get_meter(m, 0).values)
                    for m in ("loss", "accuracy")]
folds = ["--kfolds", "2", "--only-fold", "0"]
pretrained = chip_smoke.CONFIG_FLAGS["siamese_pretrained_lstm"] + small + \
    folds + ["--load-base-network", work + "/models/siamese_cnn_linear"]
trainer = main(pretrained + ["--save-model", "pretrained.pt"])
report["siamese_pretrained"] = len(trainer.results.get_meter(
    "test_auc", 0).values)
rows, votes = predict(["--checkpoint", work + "/models/pretrained-fold0",
                       "-o", work + "/p.csv", "--votes-output",
                       work + "/v.json"] + pretrained)
report["predict_rows"] = len(rows)
trainer = main(chip_smoke.CONFIG_FLAGS["autoencoder"] + small)
report["autoencoder"] = len(trainer.results.get_meter("test_loss", 0).values)
print(json.dumps(report))
"""


def test_siamese_and_autoencoder_train_without_pandas_sklearn_or_yaml(
        tmp_path):
    """One epoch of each twin network from chip_smoke.py's flags (S = 4,
    batch 4) with its checkpoint, siamese_pretrained from
    siamese_cnn_linear's tower and ``cli.predict`` on it, and one epoch of
    the autoencoder on the ``main`` holdout, with pandas, scikit-learn,
    PyYAML, JAX and deepards_tpu blocked."""
    out = subprocess.run(
        [sys.executable, "-c", _SIAMESE_WITHOUT, str(tmp_path)], cwd=ROOT,
        env={**os.environ, "PYTHONPATH": ROOT},
        capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-3000:]
    report = json.loads(out.stdout.strip().splitlines()[-1])
    for name in ("siamese_cnn_linear", "siamese_cnn_lstm",
                 "siamese_cnn_transformer"):
        losses, accuracy = report[name]
        assert losses > 0 and accuracy == 1, name
    assert report["siamese_pretrained"] == 1 and report["predict_rows"] > 0
    assert report["autoencoder"] > 0
    assert (tmp_path / "models" / "siamese_cnn_linear.scaling.json").exists()


_ANALYTICS_WITHOUT = r"""
import json, sys
for blocked in ("pandas", "sklearn", "yaml", "matplotlib", "jax",
                "deepards_tpu"):
    sys.modules[blocked] = None  # any import of them raises ImportError
import torch
torch.set_num_threads(1)
import chip_smoke
from deepards_tpu_torch.data.synthetic import generate_cohort

work = sys.argv[1]
cohort = generate_cohort(work + "/cohort", n_patients=6,
                         n_breaths_per_patient=80, seed=3)
launches = chip_smoke.phase_analytics(
    work, device="cpu", nb=4, kfolds=2, cam_kfolds=2, cam_samps=4,
    real_windows=40, cohort=(work + "/cohort", cohort),
    dtw_data=(work + "/cohort", cohort))
print(json.dumps(launches))
"""


def test_analytics_need_no_pandas_sklearn_yaml_or_matplotlib(tmp_path):
    """chip_smoke.py's analytics phase on the CPU at a small size (S = 4,
    6 patients, 2 folds): a ``--perform-dtw-preprocessing`` training with
    its frames held to the CPU's, the plot options' training (its PNG
    stages refused by name), a 40-window patient, ``cli.evaluate``
    against ``cli.predict``, the three cam CLIs (their PNG stages refused
    by name) and the results tools, with pandas, scikit-learn, PyYAML,
    matplotlib, JAX and deepards_tpu blocked."""
    out = subprocess.run(
        [sys.executable, "-c", _ANALYTICS_WITHOUT, str(tmp_path)], cwd=ROOT,
        env={**os.environ, "PYTHONPATH": ROOT},
        capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-3000:]
    launches = json.loads(out.stdout.strip().splitlines()[-1])
    assert launches == dict.fromkeys(
        ("analytics_dtw_preprocessing", "analytics_plots",
         "analytics_real_size_patient", "evaluate", "cam_analytics",
         "results_tools"), 0)
    phase = [json.loads(line) for line in out.stdout.splitlines()
             if line.startswith('{"phase": "analytics"')]
    assert len(phase) == 1
    vs_cpu = phase[0]["dtw_preprocessing"]["vs_cpu"]
    assert vs_cpu["misses"] == [] and vs_cpu["patients"] >= 2
    # each planted fault caught by the frames' contents
    for missed in vs_cpu["planted"].values():
        assert missed and not any(m.startswith("patients") for m in missed)
    assert phase[0]["results_tools"]["results_files"] == 3
    assert "PNG stage 1d_cam_intensities.png refused: matplotlib is " \
        "missing" in out.stdout
    # the plot options' run: its frames the DTW run's, its PNGs refused
    plots = phase[0]["plots"]
    assert plots["frames_unequal"] == [] and plots["frames"] >= 2
    assert plots["npz"] == len(plots["png_stages"]) > 0
    assert "PNG stage tiled_" in out.stdout
    assert (tmp_path / "analytics" / "dtw_cache").is_dir()


def test_analytics_clis_raise_without_cuda(tmp_path):
    """The new entry points refuse the default device with no card."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    import chip_smoke
    from deepards_tpu_torch.cli import cam_analytics, evaluate
    from deepards_tpu_torch.config.config import Configuration
    from deepards_tpu_torch.eval.plots import perform_dtw_preprocessing

    ds = chip_smoke.cohort_dataset(
        str(tmp_path), np.ones((4, 2, 1, 224), np.float32), [0, 1], 2)
    data = ds.save(str(tmp_path / "ds.npz"))
    with pytest.raises(RuntimeError, match="CUDA"):
        cam_analytics.main(["one-d", "-p", data, "--model-pattern",
                            str(tmp_path / "m{fold}")])
    with pytest.raises(RuntimeError, match="CUDA"):
        cam_analytics.main(["butter-plot", "-p", data, "--index", "0"])
    with pytest.raises(RuntimeError, match="CUDA"):
        evaluate.evaluate(Configuration(overrides={
            "train_from_pickle": data, "kfolds": 2}))
    rows = [{"index": int(i), "hour": 0.0, "patient": str(p)}
            for i, p in zip(ds.get_ground_truth().index,
                            ds.get_ground_truth().patient)]
    from types import SimpleNamespace
    with pytest.raises(RuntimeError, match="CUDA"):
        perform_dtw_preprocessing(SimpleNamespace(pred_to_hour_frame=rows),
                                  ds, str(tmp_path / "cache"))


def test_no_port_module_imports_yaml_or_pandas():
    """No module of the port, and not chip_smoke.py, imports PyYAML,
    pandas or pyarrow, at module level or inside a function."""
    import ast
    import glob

    files = glob.glob(os.path.join(ROOT, "deepards_tpu_torch", "**", "*.py"),
                      recursive=True) + [os.path.join(ROOT, "chip_smoke.py")]
    offenders = []
    for path in files:
        with open(path) as f:
            tree = ast.parse(f.read())
        for node in ast.walk(tree):
            if isinstance(node, ast.Import):
                names = [alias.name for alias in node.names]
            elif isinstance(node, ast.ImportFrom) and node.level == 0:
                names = [node.module]
            else:
                continue
            offenders += [(os.path.relpath(path, ROOT), node.lineno, name)
                          for name in names if name.split(".")[0] in (
                              "yaml", "pandas", "pyarrow")]
    assert len(files) > 90 and offenders == []


_EXPERIMENT_FILES_WITHOUT = r"""
import json, sys
for blocked in ("pandas", "sklearn", "yaml", "jax", "deepards_tpu"):
    sys.modules[blocked] = None  # any import of them raises ImportError
import torch
torch.set_num_threads(1)
from deepards_tpu_torch.cli.evaluate import main as evaluate
from deepards_tpu_torch.cli.train import main as train
from deepards_tpu_torch.config import yamlfile
from deepards_tpu_torch.data.synthetic import generate_cohort

work = sys.argv[1]
cohort = generate_cohort(work + "/cohort", n_patients=10,
                         n_breaths_per_patient=80, seed=3)
trainer = train([
    "-co", "deepards_tpu/config/experiment_files/"
    "unpadded_centered_nb20_cnn_linear.yml",
    "--data-path", work + "/cohort", "--cohort-file", cohort,
    "--n-sub-batches", "4", "--batch-size", "8", "--only-fold", "0",
    "--epochs", "1", "--device", "cpu", "--results-dir", work + "/results",
    "--train-to-pickle", work + "/ds.npz", "--save-model", "m.pt",
    "--saved-models-dir", work + "/models"])
layout = yamlfile.read("deepards_tpu/config/evaluate_config/"
                       "unpadded_centered_nb20_cnn_linear.yml")
layout.update(train_from_pickle=work + "/ds.npz", device="cpu",
              n_sub_batches=4, batch_size=8, results_dir=work + "/eval",
              models={0: ["m-fold0", "m-fold0"]})
yamlfile.write(work + "/evaluate.yml", layout)
rows, aggregate, ev = evaluate(["-co", work + "/evaluate.yml",
                                "--saved-models-dir", work + "/models"])
print(json.dumps({
    "conf": {k: trainer.conf.get(k) for k in (
        "kfolds", "clip_grad", "clip_val", "oversample_minority",
        "random_kfold", "epochs")},
    "steps": len(trainer.results.get_meter("loss", 0).values),
    "folds": [r["Fold"] for r in rows],
    "epochs": sorted({r["epoch_num"] for r in ev.results.results})}))
"""


def test_experiment_files_train_and_evaluate_without_pyyaml(tmp_path):
    """``cli.train -co`` of config 1's experiment file and ``cli.evaluate
    -co`` of a yml in the ``evaluate_config`` layout (``models:`` of int
    keys) run with PyYAML, pandas, scikit-learn, JAX and deepards_tpu
    blocked."""
    out = subprocess.run(
        [sys.executable, "-c", _EXPERIMENT_FILES_WITHOUT, str(tmp_path)],
        cwd=ROOT, env={**os.environ, "PYTHONPATH": ROOT},
        capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-3000:]
    report = json.loads(out.stdout.strip().splitlines()[-1])
    assert report["conf"] == {"kfolds": 5, "clip_grad": True,
                              "clip_val": 0.01, "oversample_minority": True,
                              "random_kfold": False, "epochs": 1}
    assert report["steps"] > 0
    assert report["folds"] == [0] and report["epochs"] == [0, 1]


_EXPERIMENTS_PHASE_WITHOUT = r"""
import json, sys
for blocked in ("pandas", "sklearn", "yaml", "jax", "deepards_tpu"):
    sys.modules[blocked] = None  # any import of them raises ImportError
import torch
torch.set_num_threads(1)
import chip_smoke
chip_smoke.phase_experiments(
    sys.argv[1], device="cpu", breaths=240,
    sweep_files=("unpadded_centered_nb20_cnn_linear.yml",
                 "holdout_with_similarity_split.yml"))
"""


def test_experiments_phase_needs_no_yaml_or_pandas(tmp_path):
    """chip_smoke.py's experiments phase on the CPU at a small size (a
    10 x 240 cohort, 2 swept configs), with PyYAML, pandas, scikit-learn,
    JAX and deepards_tpu blocked: every check and planted fault."""
    out = subprocess.run(
        [sys.executable, "-c", _EXPERIMENTS_PHASE_WITHOUT, str(tmp_path)],
        cwd=ROOT, env={**os.environ, "PYTHONPATH": ROOT},
        capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-3000:]
    phase = [json.loads(line) for line in out.stdout.splitlines()
             if line.startswith('{"phase": "experiments"')]
    assert len(phase) == 1
    fields = phase[0]
    assert len(fields["files"]["equal"]) == 5
    assert fields["files"]["planted_caught"] == ["batch_size"]
    assert fields["reference_pickle"]["losses_equal"]
    assert fields["reference_pickle"]["planted_caught"] == ["hours"]
    assert fields["evaluate"]["max_abs_pred_frac_vs_eval"] <= 1e-5
    assert sorted(fields["sweep"]["wall_s"]) == [
        "holdout_with_similarity_split.yml",
        "unpadded_centered_nb20_cnn_linear.yml"]
    assert fields["profiling"]["step_spans"] == 3


def test_matplotlib_and_sklearn_only_inside_functions():
    """No module of the port, and not chip_smoke.py, imports matplotlib or
    scikit-learn at module level; the modules that draw or fit import them
    inside the function that does."""
    import ast
    import glob

    files = glob.glob(os.path.join(ROOT, "deepards_tpu_torch", "**", "*.py"),
                      recursive=True) + [os.path.join(ROOT, "chip_smoke.py")]
    top, inside = [], set()
    for path in files:
        with open(path) as f:
            tree = ast.parse(f.read())
        nested = {id(n) for fn in ast.walk(tree)
                  if isinstance(fn, (ast.FunctionDef, ast.AsyncFunctionDef))
                  for n in ast.walk(fn)}
        for node in ast.walk(tree):
            if isinstance(node, ast.Import):
                names = [alias.name for alias in node.names]
            elif isinstance(node, ast.ImportFrom) and node.level == 0:
                names = [node.module]
            else:
                continue
            for name in names:
                if name.split(".")[0] in ("matplotlib", "sklearn"):
                    rel = os.path.relpath(path, ROOT)
                    if id(node) in nested:
                        inside.add((rel, name.split(".")[0]))
                    else:
                        top.append((rel, node.lineno, name))
    assert top == []
    assert {("deepards_tpu_torch/utils/figures.py", "matplotlib"),
            ("deepards_tpu_torch/cli/dl_vs_rf.py", "sklearn")} <= inside
