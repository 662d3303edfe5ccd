"""The port's experiment launchers against the JAX package's:
``cli.run_experiments`` queues the same commands (only the module and the
device variable differ), and ``cli.registry_sweep`` runs generated ymls
through the port's ``cli.train`` on the CPU, resumes, and records a
refused option as an error."""
import json
import os
import sys

import pytest
import torch

from deepards_tpu.cli import run_experiments as jrun
from deepards_tpu_torch.cli import registry_sweep
from deepards_tpu_torch.cli import run_experiments as trun

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
EXP = os.path.join(ROOT, "deepards_tpu", "config", "experiment_files",
                   "unpadded_centered_nb20_cnn_linear.yml")
SWEPT = ("unpadded_centered_nb20_cnn_linear.yml",
         "heterogeneity.yml", "protopnet_unpadded_centered.yml")


def _launched(module, argv, monkeypatch):
    """(command, the device variable's value) of every run ``module``
    launches, with ``subprocess.run`` recording instead of running."""
    calls = []

    def record(cmd, check, env):
        calls.append((cmd, {k: env.get(k) for k in (
            "CUDA_VISIBLE_DEVICES", "TPU_VISIBLE_DEVICES")}))

    monkeypatch.setattr(module.subprocess, "run", record)
    module.main(argv)
    return calls


@pytest.mark.parametrize("argv", [
    [EXP, "-n", "1", "--grid", "base-network=resnet18,densenet18",
     "batch-size=16,32", "--extra-args", "--epochs", "1"],
    [EXP, EXP, "-n", "2"],
    [EXP, "-n", "3", "--device-assignment", "0+1"],
], ids=["grid", "n2", "devices"])
def test_run_experiments_queues_the_jax_commands(argv, monkeypatch, capsys):
    for key in ("CUDA_VISIBLE_DEVICES", "TPU_VISIBLE_DEVICES"):
        monkeypatch.delenv(key, raising=False)
    want = _launched(jrun, argv, monkeypatch)
    jax_out = capsys.readouterr().out
    got = _launched(trun, argv, monkeypatch)
    port_out = capsys.readouterr().out
    assert got and len(got) == len(want)
    for (cmd, env), (jcmd, jenv) in zip(got, want):
        assert cmd[:3] == [sys.executable, "-m",
                           "deepards_tpu_torch.cli.train"]
        assert jcmd[:3] == [sys.executable, "-m", "deepards_tpu.cli.train"]
        assert cmd[3:] == jcmd[3:]
        assert env["CUDA_VISIBLE_DEVICES"] == jenv["TPU_VISIBLE_DEVICES"]
        assert env["TPU_VISIBLE_DEVICES"] is None
        assert jenv["CUDA_VISIBLE_DEVICES"] is None
    assert port_out == jax_out.replace("deepards_tpu.cli.train",
                                       "deepards_tpu_torch.cli.train")
    # --dry-run lists the same commands and launches none
    dry = trun.main(["--dry-run"] + argv)
    assert [c for c, _ in dry] == [c for c, _ in got]
    assert capsys.readouterr().out == port_out


@pytest.fixture(scope="module")
def sweep_dir(tmp_path_factory):
    return tmp_path_factory.mktemp("sweep")


def test_registry_sweep_runs_and_resumes(sweep_dir, capsys):
    """A k-fold, a holdout and a ProtoPNet config each train one debug
    epoch and an eval through the port on the CPU; a second call skips
    the configs already ok."""
    out = str(sweep_dir / "sweep.json")
    cohort = str(sweep_dir / "cohort")
    argv = ["--out", out, "--cohort", cohort, "--device", "cpu", "--only",
            *SWEPT]
    results = registry_sweep.main(argv)
    assert sorted(results) == sorted(SWEPT)
    for name in SWEPT:
        assert results[name]["ok"], results[name]
        assert results[name]["error"] is None
        assert results[name]["backend"] == "cpu"
        assert results[name]["wall_s"] >= 0
    with open(out) as f:
        assert json.load(f) == results
    registry = sweep_dir / "registry"
    assert len([n for n in os.listdir(str(registry))
                if n.endswith(".yml")]) == 228
    # the holdout's directories and the similarity splits' are linked
    assert (sweep_dir / "cohort" / "experiment1" /
            "fold_0_similarity_splittrain" / "raw").exists()
    capsys.readouterr()
    again = registry_sweep.main(argv)
    assert again == results
    assert "[1/3]" not in capsys.readouterr().out  # nothing re-ran


def test_registry_sweep_records_a_refused_option(sweep_dir):
    """A yml with an option the port refuses is an error of the sweep's
    record, not a crash."""
    registry = registry_sweep.ensure_registry(str(sweep_dir))
    cohort = str(sweep_dir / "cohort")
    csv = registry_sweep.ensure_cohort(cohort)
    bad = sweep_dir / "refused.yml"
    with open(os.path.join(registry,
                           "unpadded_centered_nb20_cnn_linear.yml")) as f:
        bad.write_text(f.read() + "model_devices: 2\n")
    error = registry_sweep.run_one(str(bad), cohort, csv, "cpu")
    assert error.startswith("NotImplementedError")
    assert "model_devices" in error
    assert not [n for n in os.listdir(str(sweep_dir))
                if n.startswith("regsweep_")]  # its results dir is gone


def test_registry_sweep_argv_keeps_the_jax_flags(sweep_dir):
    """The JAX sweep's flags; a config naming a holdout and kfolds gets
    the 2 folds too, and small train fractions the wide cohort."""
    registry = registry_sweep.ensure_registry(str(sweep_dir))
    cohort = str(sweep_dir / "argv" / "cohort")
    csv, res = cohort + "/c.csv", "/r"

    def argv(name):
        return registry_sweep.sweep_argv(os.path.join(registry, name),
                                         cohort, csv, res, "cuda")

    flags = argv("unpadded_centered_nb20_cnn_linear.yml")
    assert flags[2:] == [
        "--data-path", cohort, "--cohort-file", csv, "--epochs", "1",
        "--debug", "-b", "4", "--n-sub-batches", "4", "--compute-dtype",
        "float32", "--results-dir", res, "--seed", "5", "--device", "cuda",
        "--kfolds", "2", "--only-fold", "0"]
    assert "--kfolds" not in argv("heterogeneity.yml")
    assert "--kfolds" not in argv("heterogeneity_filter_by_train_10.yml")
    assert "--kfolds" in argv("heterogeneity_kfold.yml")
    wide = argv("train_frac1.yml")
    assert wide[wide.index("--data-path") + 1] == str(
        sweep_dir / "argv" / "regsweep_wide")


def test_registry_sweep_runs_a_bootstrap_config(sweep_dir):
    """A bootstrap config's test split can be empty on the sweep's
    cohort; the port's eval then records nothing, as the JAX run does
    (it failed on the empty split before)."""
    registry = registry_sweep.ensure_registry(str(sweep_dir))
    cohort = str(sweep_dir / "cohort")
    csv = registry_sweep.ensure_cohort(cohort)
    assert registry_sweep.run_one(os.path.join(
        registry, "unpadded_centered_nb20_cnn_linear_bootstrap.yml"),
        cohort, csv, "cpu") is None
