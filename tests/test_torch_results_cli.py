"""The results tools and ``cli.cam_analytics`` on the CPU against the JAX
package.

``cli.evaluate``: the JAX CLI and the port's over the same numpy-drawn
per-fold cnn_linear params (an orbax checkpoint for JAX, an ``.npz`` of
the flat params for the port), two pseudo-epochs of fold 0's checkpoint
and one of fold 1's, on the seeded cohort of
``test_torch_patient_gradcam.py`` (S = 3, 2 folds), float32, dropout off
on both sides: patient rows equal (pred_frac within 1e-12), the fold
table equal (AUC within 1e-6), the aggregated stats equal (AUC within
1e-6).  ``mean_metrics`` against the JAX function over the same rows of
two runs (the JAX side reads pandas pickles written from them), with two
epochs of a fold tied on AUC, and its pandas sort order on ties and NaN.
``find_all_experiments`` and ``load_meters`` against the JAX functions on
the same records.  ``cli.cam_analytics`` end to end: each subcommand
through ``main`` with ``--device cpu``, its saved columns against the JAX
study over the same params (figures not saved).
"""
import json
import os
import pickle
import re
from types import SimpleNamespace

import jax
import matplotlib
import matplotlib.figure
import numpy as np
import pandas as pd
import pytest
import torch
import yaml
from flax import traverse_util
from test_torch_frequency_analytics import (
    S,
    close,
    datasets,
    jax_factory,
)
from test_torch_frequency_analytics import setup as freq_setup  # noqa: F401
from test_torch_patient_gradcam import cnn_linear, save_cohort

import deepards_tpu.train.steps as jsteps
import deepards_tpu_torch.train.steps as tsteps
from deepards_tpu.cli import evaluate as jevaluate
from deepards_tpu.cli import find_all_experiments as jfind
from deepards_tpu.cli import mean_metrics as jmean
from deepards_tpu.cli import visualize_results as jvisualize
from deepards_tpu.explain import frequency_analytics as jfa
from deepards_tpu.train import checkpoint as jckpt
from deepards_tpu_torch.cli import cam_analytics
from deepards_tpu_torch.cli import evaluate
from deepards_tpu_torch.cli import find_all_experiments as find
from deepards_tpu_torch.cli import mean_metrics
from deepards_tpu_torch.cli import visualize_results
from deepards_tpu_torch.eval.metrics import STAT_COLUMNS

matplotlib.use("Agg")
# parallel test workers share the cores: one torch thread each
torch.set_num_threads(1)


@pytest.fixture(autouse=True)
def no_png(monkeypatch):
    monkeypatch.setattr(matplotlib.figure.Figure, "savefig",
                        lambda self, path, **kw: None)


def _no_dropout(make_train_step):
    def wrapped(*args, **kw):
        kw["dropout_active"] = False
        kw["eval_dropout_active"] = False
        return make_train_step(*args, **kw)
    return wrapped


def save_params(root, name, params):
    """(orbax checkpoint for the JAX CLIs, .npz of flat params for the
    port's)."""
    jckpt.save(os.path.join(root, name), SimpleNamespace(
        params=params, opt_state={}, rng=jax.random.PRNGKey(0), step=0))
    np.savez(os.path.join(root, name + ".npz"),
             **traverse_util.flatten_dict(params, sep="/"))


def write_yml(path, **conf):
    with open(path, "w") as f:
        yaml.safe_dump(conf, f)
    return path


def mean_results_table(out):
    """The JAX CLI's printed fold table as rows."""
    text = out.split("Mean Results")[1].split("Aggregated Results")[0]
    lines = [ln.split() for ln in text.strip().splitlines()]
    return [dict(zip(lines[0], (float(v) for v in ln))) for ln in lines[1:]]


def test_evaluate_matches_jax(tmp_path, capsys, monkeypatch):
    data = save_cohort(str(tmp_path), total_kfolds=2)
    models_dir = str(tmp_path / "models")
    for fold in (0, 1):
        _, params, _ = cnn_linear(seed=10 + fold)
        save_params(models_dir, "f{}".format(fold), params)
    common = dict(train_from_pickle=data, network="cnn_linear",
                  base_network="densenet18", n_sub_batches=S, batch_size=4,
                  kfolds=2, compute_dtype="float32", dp_devices=1)
    monkeypatch.setattr(jsteps, "make_train_step",
                        _no_dropout(jsteps.make_train_step))
    monkeypatch.setattr(tsteps, "make_train_step",
                        _no_dropout(tsteps.make_train_step))
    jevaluate.main(["-co", write_yml(
        str(tmp_path / "jax.yml"), results_dir=str(tmp_path / "jax"),
        models={0: ["f0", "f0"], 1: ["f1"]}, **common),
        "--saved-models-dir", models_dir])
    want_table = mean_results_table(capsys.readouterr().out)
    rows, aggregate, trainer = evaluate.main(["-co", write_yml(
        str(tmp_path / "port.yml"), results_dir=str(tmp_path / "port"),
        models={0: ["f0.npz", "f0.npz"], 1: ["f1.npz"]}, device="cpu",
        **common), "--saved-models-dir", models_dir])

    want_rows = pd.read_pickle(next(
        os.path.join(tmp_path / "jax", n)
        for n in os.listdir(tmp_path / "jax")
        if n.endswith("_patient_results.pkl")))
    got_rows = trainer.results.results
    assert len(got_rows) == len(want_rows) == 6
    for got, (_, want) in zip(got_rows, want_rows.iterrows()):
        for key, value in got.items():
            if key == "pred_frac":
                assert abs(value - want[key]) <= 1e-12
            else:
                assert value == want[key], key
    # two pseudo-epochs of one checkpoint are equal
    epochs = {e: [(r["patient"], r["pred_frac"]) for r in got_rows
                  if r["fold_num"] == 0 and r["epoch_num"] == e]
              for e in (0, 1)}
    assert epochs[0] == epochs[1]
    assert len(rows) == len(want_table) == 2
    for got, want in zip(rows, want_table):
        assert (got["Fold"], got["Accuracy"]) == (want["Fold"],
                                                  want["Accuracy"])
        assert abs(got["AUC"] - want["AUC"]) <= 1e-6
    want_agg = pd.read_pickle(next(
        os.path.join(tmp_path / "jax", n)
        for n in os.listdir(tmp_path / "jax")
        if n.endswith("_aggregate_results.pkl")))
    assert len(aggregate) == len(want_agg)
    for got, (_, want) in zip(aggregate, want_agg.iterrows()):
        for key in STAT_COLUMNS:
            if key == "auc":
                assert abs(got[key] - want[key]) <= 1e-6
            else:
                assert got[key] == want[key], key


def result_rows(seed):
    """Patient rows of 2 folds x 3 epochs; in fold 0, epochs 1 and 2 have
    the same pred_frac (a tie on AUC) and different predictions."""
    rng = np.random.default_rng(seed)
    rows = []
    for fold in (0, 1):
        fracs = {}
        for epoch in (1, 2, 3):
            frac = rng.uniform(size=6).round(3)
            if fold == 0 and epoch == 2:
                frac = fracs[1]
            fracs[epoch] = frac
            pred = (frac >= (0.5 if epoch != 2 else 0.3)).astype(int)
            for k in range(6):
                rows.append({"patient": str(k), "patho": k % 2,
                             "prediction": int(pred[k]),
                             "pred_frac": float(frac[k]),
                             "epoch_num": epoch, "fold_num": fold})
    return rows


def test_mean_metrics_matches_jax(tmp_path):
    port_files, jax_files = [], []
    for run in (0, 1):
        rows = result_rows(run)
        port_files.append(str(tmp_path / "e_results_{}.json".format(run)))
        with open(port_files[-1], "w") as f:
            json.dump({"results": rows}, f)
        jax_files.append(str(tmp_path / "{}_patient_results.pkl".format(
            run)))
        pd.DataFrame(rows).to_pickle(jax_files[-1])
    want, want_stats = jmean.get_metrics(jax_files)
    got, got_stats = mean_metrics.get_metrics(port_files)
    assert list(got) == list(want.columns)
    for name in want.columns:
        np.testing.assert_array_equal(got[name], want[name].to_numpy())
    # the AUC of eval.metrics and scikit-learn's part by rounding
    for name in want_stats.columns:
        np.testing.assert_allclose(got_stats[name],
                                   want_stats[name].to_numpy(), rtol=0,
                                   atol=1e-12)
    # fold 0's best epochs, 1 and 2, tie on mean AUC: the pick is pandas'
    means = want_stats.groupby(["fold", "epoch"]).AUC.mean()[0]
    assert means[1] == means[2] == means.max()
    assert got["max_epoch"][0] == want.max_epoch[0]
    assert mean_metrics.main(["--results-dir", str(tmp_path)])[
        "max_epoch"].tolist() == want.max_epoch.tolist()


@pytest.mark.parametrize("n", [5, 40, 200])
def test_sort_descending_is_pandas_order(n):
    rng = np.random.default_rng(n)
    values = rng.integers(0, 4, n).astype(np.float64) / 4
    values[rng.uniform(size=n) < 0.1] = np.nan
    want = pd.DataFrame({"v": values}).sort_values(
        "v", ascending=False).index.to_numpy()
    np.testing.assert_array_equal(mean_metrics.sort_descending(values), want)


def test_find_all_experiments_matches_jax(tmp_path):
    for k, (name, network) in enumerate((("exp_a", "cnn_linear"),
                                         (None, "cnn_lstm"))):
        hp = {"conf": {"experiment_name": name, "network": network},
              "start_time": str(1000 + k)}
        stem = "{}_u{}".format(name or "u", k)
        with open(tmp_path / (stem + ".pkl"), "wb") as f:
            pickle.dump(hp, f)
        with open(tmp_path / (stem + ".json"), "w") as f:
            json.dump(hp, f)
    with open(tmp_path / "exp_a_results_u0.json", "w") as f:
        json.dump({"results": []}, f)
    want = jfind.find_experiments(str(tmp_path))
    got = find.find_experiments(str(tmp_path))
    assert len(got) == len(want) == 2
    for g, w in zip(got, want):
        assert g["file"][:-5] == w["file"][:-4]
        assert {k: g[k] for k in ("experiment", "network", "start_time")} \
            == {k: w[k] for k in ("experiment", "network", "start_time")}


def test_load_meters_matches_jax(tmp_path):
    for t in ("11", "12"):
        np.savez(tmp_path / "meters_deepards_start_{}.npz".format(t),
                 test_auc_fold_0=np.arange(3.0) + int(t),
                 loss_fold_0=np.ones(4))
    for start in (None, "12"):
        want = jvisualize.load_meters(str(tmp_path), start)
        got = visualize_results.load_meters(str(tmp_path), start)
        assert list(got) == list(want)
        for run in want:
            assert sorted(got[run]) == sorted(want[run])
            for k in want[run]:
                np.testing.assert_array_equal(got[run][k], want[run][k])
    assert visualize_results.main(["--results-dir", str(tmp_path)]) is None


def saved_columns(out_dir, stem):
    with np.load(os.path.join(out_dir, stem + ".npz")) as z:
        return {k.replace("_", " ") if k == "Cam_Intensity" else k: z[k]
                for k in z.files}


def assert_columns(got, want):
    assert sorted(got) == sorted(want.columns)
    for name in want.columns:
        close(got[name], want[name].to_numpy())


@pytest.mark.parametrize("cmd", ["one-d", "two-d", "butter", "butter-plot"])
def test_cam_analytics_cli_end_to_end(freq_setup, tmp_path, cmd,  # noqa
                                      capsys):
    setup = freq_setup
    kind = "raw" if cmd.startswith("butter") else "fft"
    jds, _ = datasets(setup, kind)
    jmodel, params, _ = setup[kind]
    for fold, p in params.items():
        np.savez(str(tmp_path / "ckpt-fold{}.npz".format(fold)),
                 **traverse_util.flatten_dict(p, sep="/"))
    data = setup["paths"][kind]
    out = str(tmp_path / "out")
    if cmd == "butter-plot":
        signal = cam_analytics.main([cmd, "-p", data, "--index", "3", "-lf",
                                     "1", "-hf", "10", "-o", out,
                                     "--device", "cpu"])
        assert signal.shape == (224,)
        assert os.path.exists(os.path.join(out, "butter_plot.npz"))
        return
    argv = [cmd, "-p", data, "--model-pattern",
            str(tmp_path / "ckpt-fold{fold}.npz"), "--folds", "2", "-o", out,
            "-n", "3", "--device", "cpu"]
    if cmd == "butter":
        argv += ["--no-filter-pickle", data, "-lf", "0", "-hf", "5"]
    cam_analytics.main(argv)
    printed = capsys.readouterr().out
    assert ".png" in printed  # the PNG stages run on the CPU host
    stem = cmd.replace("-", "_")
    got = saved_columns(out, stem + "_intensity")
    factory = jax_factory(jmodel)
    if cmd == "one-d":
        want = jfa.one_d_analytics(factory, jds, params, str(tmp_path),
                                   n_samps=3)
        assert_columns(saved_columns(out, "one_d_bands"), want["bands"])
    elif cmd == "two-d":
        want = jfa.two_d_analytics(factory, jds, params, str(tmp_path),
                                   n_samps=3)
    else:
        want = jfa.butterworth_1d_analytics(
            factory, jds, jds, params, "butter", 0, 5, str(tmp_path),
            n_samps=3)
        with np.load(os.path.join(out, "butter_prototypes.npz")) as z:
            for (patho, tag), value in want["prototypes"].items():
                close(z["prototype_{}_{}".format(patho, tag)], value)
    assert_columns(got, want["intensity"])
    assert re.search("intensit", printed)
