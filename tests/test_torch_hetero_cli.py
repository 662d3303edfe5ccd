"""The heterogeneity workflow's CLIs and files: the port against the JAX
package.

Split files (``config/splitfile.py`` against PyYAML), ``cli.sim_dissim``
``generate``/``hetero``/``breakdown`` and ``cli.analysis`` through
``main(argv)`` on one saved ``.npz`` dataset that both packages read,
``cli.perform_data_splitting`` on two copies of one synthetic cohort, and
the analysis functions.  File names and symlink trees are equal, split
files ``yaml.safe_load``-equal, stats equal, DTW means within rtol 1e-6,
the signal statistics within 1e-5 of their scale.
"""
import csv
import json
import os

import numpy as np
import pandas as pd
import pytest
import scipy.signal
import torch
import yaml

from deepards_tpu.cli import analysis as janalysis
from deepards_tpu.cli import perform_data_splitting as jsplit
from deepards_tpu.cli import sim_dissim as jsim
from deepards_tpu.data.dataset import ARDSRawDataset as JaxDataset
from deepards_tpu.data.synthetic import generate_cohort
from deepards_tpu.eval.metrics import DeepARDSResults as JaxResults
from deepards_tpu_torch.cli import analysis, perform_data_splitting, sim_dissim
from deepards_tpu_torch.config import splitfile
from deepards_tpu_torch.data import pipeline
from deepards_tpu_torch.data.dataset import ARDSRawDataset
from deepards_tpu_torch.data.windowing import WindowCache
from deepards_tpu_torch.dtw import lib
from deepards_tpu_torch.eval.metrics import DeepARDSResults

# parallel test workers share the cores: one torch thread each
torch.set_num_threads(1)

CLOSE = dict(rtol=1e-6, atol=0)
# ids that YAML would read as numbers, a bool or a date unless quoted
PATIENTS = ["0012", "123", "7", "pt_4", "05", "true", "1.5", "8", "2017-01-01",
            "10", "a-11", "12"]


@pytest.fixture(scope="module")
def saved(tmp_path_factory):
    """A seeded cohort of 12 patients x 4 windows of (1, 1, 224), saved as
    the ``.npz`` both packages read: {path, port, jax}."""
    root = tmp_path_factory.mktemp("hetero")
    rng = np.random.default_rng(21)
    n_win = 4
    base = rng.normal(scale=30.0, size=(len(PATIENTS), 1, 1, 224))
    data = (np.repeat(base, n_win, axis=0)
            + rng.normal(scale=5.0, size=(len(PATIENTS) * n_win, 1, 1, 224)))
    patho = np.arange(len(PATIENTS)) % 2
    cohort = str(root / "cohort.csv")
    with open(cohort, "w", newline="") as f:
        writer = csv.writer(f)
        writer.writerow(["Patient Unique Identifier", "Pathophysiology"])
        writer.writerows([p, "ARDS" if y else "OTHER"]
                         for p, y in zip(PATIENTS, patho))
    cache = WindowCache(
        data=data.astype(np.float32),
        target=np.eye(2, dtype=np.float32)[np.repeat(patho, n_win)],
        hours=np.tile(np.arange(n_win, dtype=np.float32) * 5.5 + 0.25,
                      len(PATIENTS))[:, None],
        patient_idx=np.repeat(np.arange(len(PATIENTS)), n_win).astype(
            np.int32),
        patients=list(PATIENTS))
    path = ARDSRawDataset(str(root), 1, cohort, 1,
                          "unpadded_centered_sequences", cache=cache).save(
                              str(root / "cohort.npz"))
    return {"path": path, "root": root,
            "port": ARDSRawDataset.from_pickle(path),
            "jax": JaxDataset.from_pickle(path)}


def _loaded(paths):
    out = {}
    for p in paths:
        with open(p) as f:
            out[os.path.basename(p)] = yaml.safe_load(f)
    return out


@pytest.mark.parametrize("argv", [
    ["generate", "--n-pts", "4", "--retrieve-n", "2"],
    ["hetero", "--n-splits", "3", "--train-n", "4", "--test-n", "2",
     "--mean-similarity-thresh", "0.9", "--seed", "5"],
    ["hetero", "--n-splits", "3", "--train-n", "4", "--test-n", "2",
     "--dist-method", "same_ordered"],
])
def test_sim_dissim_main_matches_jax(saved, tmp_path, argv):
    common = ["--train-from-pickle", saved["path"]]
    got = sim_dissim.main(argv + common + [
        "-o", str(tmp_path / "port"), "--device", "cpu"])
    jsim.main(argv + common + ["-o", str(tmp_path / "jax")])
    names = sorted(os.listdir(tmp_path / "jax"))
    assert sorted(os.path.basename(p) for p in got) == names and names
    want = _loaded(tmp_path / "jax" / n for n in names)
    assert _loaded(got) == want
    for name in names:  # the reader on files yaml.dump wrote
        assert splitfile.read(str(tmp_path / "jax" / name)) == want[name]
    if argv[0] == "hetero":
        split = want["train_sim_test_sim_dissim_split_1.yml"]
        assert not set(split["train"]) & set(split["test"])
        assert set(split["test"]) == set(split["similar"]) | set(
            split["dissimilar"])


def _results(ds, jds, epochs, rng, results_dir):
    """Patient rows of both packages over random window predictions."""
    gt = ds.get_ground_truth()
    port = DeepARDSResults(0, "hetero", results_dir=results_dir)
    jax_res = JaxResults(0, "hetero", results_dir=results_dir)
    jgt = jds.get_ground_truth_df()
    for epoch in range(1, epochs + 1):
        preds = rng.integers(0, 2, size=len(gt.index))
        port.perform_patient_predictions(gt, gt.index, preds, 0, epoch,
                                         verbose=False)
        jax_res.perform_patient_predictions(
            jgt, pd.Series(preds, index=jgt.index), 0, epoch, verbose=False)
    return port, jax_res


def test_breakdown_main_matches_jax(saved, tmp_path, capsys):
    ds, jds = saved["port"], saved["jax"]
    port, jax_res = _results(ds, jds, 2, np.random.default_rng(2),
                             str(tmp_path))
    port.save_all()
    record = [n for n in os.listdir(tmp_path) if "_results_" in n]
    pkl = str(tmp_path / "patient_results.pkl")
    jax_res.results.to_pickle(pkl)
    split = {"train": PATIENTS[:4], "test": PATIENTS[4:9],
             "similar": PATIENTS[4:6], "dissimilar": PATIENTS[6:9]}
    split_file = str(tmp_path / "split.yml")
    with open(split_file, "w") as f:
        yaml.dump(split, f)
    got = sim_dissim.main(["breakdown", str(tmp_path / record[0]),
                           split_file])
    printed = capsys.readouterr().out
    jsim.main(["breakdown", pkl, split_file])
    assert "---- dissimilar test patients ----" in capsys.readouterr().out
    want = jsim.sim_dissim_breakdown(jax_res.results, split)
    assert sorted(got) == sorted(want) == ["dissimilar", "similar"]
    for kind, stats in want.items():
        rows = stats.to_dict("records")
        assert len(rows) == len(got[kind]) == 2
        for g, w in zip(got[kind], rows):
            assert g.keys() == w.keys()
            for k in g:
                assert g[k] == w[k] or (pd.isna(g[k]) and pd.isna(w[k])), (
                    kind, k)
    assert "---- similar test patients ----" in printed
    # the patient rows file of a run gives the same
    rows_file = str(tmp_path / "rows.json")
    with open(rows_file, "w") as f:
        json.dump(port.results, f)
    assert sim_dissim.main(["breakdown", rows_file, split_file]) == got


def test_analyze_predictions_matches_jax(saved, tmp_path, capsys):
    ds, jds = saved["port"], saved["jax"]
    port, jax_res = _results(ds, jds, 3, np.random.default_rng(4),
                             str(tmp_path))
    port.save_all()
    record = [n for n in os.listdir(tmp_path) if "_results_" in n][0]
    pkl = str(tmp_path / "patient_results.pkl")
    jax_res.results.to_pickle(pkl)
    got = analysis.main(["analyze-predictions", str(tmp_path / record)])
    assert "mean_pred_frac" in capsys.readouterr().out
    want = janalysis.analyze_predictions(pkl).to_dict("records")
    assert [r["patient"] for r in got] == [r["patient"] for r in want]
    for g, w in zip(got, want):
        assert g.keys() == w.keys()
        for k in g:
            assert g[k] == w[k] or (pd.isna(g[k]) and pd.isna(w[k])), k


def test_lstm_dtw_main_matches_jax_and_reads_its_cache(saved, tmp_path,
                                                       monkeypatch):
    argv = ["lstm-dtw", "--train-from-pickle", saved["path"], "--cache-dir"]
    got = analysis.main(argv + [str(tmp_path / "port"), "--device", "cpu"])
    want = janalysis.lstm_dtw_analysis(saved["jax"], str(tmp_path / "jax"))
    assert list(got["per_patient_mean_dtw"]) == list(
        want["per_patient_mean_dtw"]) == PATIENTS
    np.testing.assert_allclose(
        list(got["per_patient_mean_dtw"].values()),
        list(want["per_patient_mean_dtw"].values()), **CLOSE)
    np.testing.assert_allclose(got["fold_mean_dtw"], want["fold_mean_dtw"],
                               **CLOSE)

    def no_dtw(*args, **kw):
        raise AssertionError("a cached patient ran the DTW")

    monkeypatch.setattr(lib, "batched_dtw_pairs", no_dtw)
    assert analysis.main(argv + [str(tmp_path / "port"), "--device",
                                 "cpu"]) == got
    # the JAX CLI chooses a fold of a dataset saved without folds
    with pytest.raises(ValueError, match="folds"):
        janalysis.main(argv + [str(tmp_path / "jax")])


def test_regression_dtw_features_matches_jax(saved, tmp_path):
    ds, jds = saved["port"], saved["jax"]
    gt = ds.get_ground_truth()
    rng = np.random.default_rng(8)
    rows = [{"index": int(i), "pred": int(rng.integers(0, 2)),
             "hour": float(ds.cache.hours[i, 0] + rng.uniform(0, 0.5)),
             "patient": str(p), "y": int(y)}
            for i, p, y in zip(gt.index, gt.patient, gt.y)]
    got, fit = analysis.regression_dtw_features(
        ds, rows, str(tmp_path / "port"), window_hours=6.0, device="cpu")
    wfeats, wfit = janalysis.regression_dtw_features(
        jds, pd.DataFrame(rows).set_index("index"), str(tmp_path / "jax"),
        window_hours=6.0)
    want = wfeats.to_dict("records")
    assert len(got) == len(want) > 3
    for g, w in zip(got, want):
        assert g["patient"] == w["patient"] and g["hour"] == w["hour"]
        np.testing.assert_allclose(
            [g[k] for k in ("mean_dtw", "std_dtw", "pred_frac")],
            [w[k] for k in ("mean_dtw", "std_dtw", "pred_frac")], **CLOSE)
    for k in ("intercept", "slope", "r2"):
        np.testing.assert_allclose(fit[k], wfit[k], rtol=1e-5)


@pytest.mark.parametrize("configs", [((None, None), (0, 10.0)),
                                     ((0.5, None), (1.0, 8.0), (2.0, 25))])
def test_signal_distributions_matches_jax(saved, configs):
    """Raw and low-, high- and band-passed statistics within 1e-5 of the
    JAX package's, relative to the larger of the value and the filtered
    values' std: a band-passed mean lies near 0, where the JAX package's
    float32 scan is 7e-7 off scipy's float64 filter and the port (one
    product with the impulse-response matrix) 4e-8.  The port's also
    within 1e-6 of scipy's, relative to the same scale."""
    got = analysis.signal_distributions(saved["port"], configs, device="cpu")
    want = janalysis.signal_distributions(saved["jax"], configs)
    data = saved["port"].cache.data.astype(np.float64)
    assert list(got) == list(want) and len(got) == len(configs)
    for (low, high), (name, stats) in zip(configs, want.items()):
        sos = pipeline.design_butter_sos(low, high)
        vals = data if sos is None else scipy.signal.sosfilt(
            sos.astype(np.float64), data, axis=-1)
        exact = {"mean": vals.mean(), "std": vals.std(),
                 "p01": np.percentile(vals, 1),
                 "p99": np.percentile(vals, 99)}
        assert list(got[name]) == list(stats) == list(exact)
        for k, v in stats.items():
            scale = max(abs(v), stats["std"])
            assert abs(got[name][k] - v) <= 1e-5 * scale
            assert abs(got[name][k] - exact[k]) <= 1e-6 * scale


def _link_tree(data_path):
    """{split dir/kind/patient: link target relative to the data path}."""
    exp = os.path.join(data_path, "experiment1")
    out = {}
    for split in sorted(os.listdir(exp)):
        if split == "all_data":
            continue
        for kind in ("raw", "meta"):
            for pt in os.listdir(os.path.join(exp, split, kind)):
                link = os.path.join(exp, split, kind, pt)
                out["/".join((split, kind, pt))] = os.path.relpath(
                    os.readlink(link), data_path)
    return out


@pytest.mark.parametrize("argv", [
    ["random", "--seed", "3"],
    ["random", "--seed", "4", "-ntr", "6", "-nv", "2", "-nt", "4", "-o",
     "mine"],
    ["preset_file", "-f", "{split}"],
])
def test_perform_data_splitting_matches_jax(tmp_path, argv):
    trees = []
    split = str(tmp_path / "train_sim_test_sim_dissim_split_1.yml")
    splitfile.write(split, {"train": ["1", "2", "5", "6"],
                            "test": ["3", "12"], "similar": ["3"],
                            "dissimilar": ["12"]})
    args = [a.format(split=split) for a in argv]
    for name, main in (("port", perform_data_splitting.main),
                       ("jax", jsplit.main)):
        data_path = str(tmp_path / name)
        cohort = generate_cohort(data_path, n_patients=12,
                                 n_breaths_per_patient=5, seed=1)
        main(["-dp", data_path, "-c", cohort] + args)
        trees.append(_link_tree(data_path))
    assert trees[0] == trees[1] and trees[0]


def test_splitter_keeps_ids_as_spelled(tmp_path):
    """An id of digits stays as the cohort CSV spells it; the JAX package's
    pandas reads '0012' as 12, whose patient directory does not exist."""
    cohort = tmp_path / "cohort.csv"
    cohort.write_text("Patient Unique Identifier,Pathophysiology\n"
                      "0012,ARDS\n0034,OTHER\n56,ARDS\n")
    got = perform_data_splitting.Splitting(str(tmp_path), str(cohort))
    want = jsplit.Splitting(str(tmp_path), str(cohort))
    assert (got.ards_pts, got.other_pts) == (["0012", "56"], ["0034"])
    assert (want.ards_pts, want.other_pts) == (["12", "56"], ["34"])


def test_split_file_round_trip_equals_yaml():
    content = {"train": PATIENTS + ["o'brien", "x y", "-a", "", "ü", "y"],
               "test": [], "cost": 12345.678, "kind": "sim", "big": 1e20,
               "neg": -0.5, "inf": float("-inf")}
    text = splitfile.dumps(content)
    assert yaml.safe_load(text) == yaml.safe_load(yaml.dump(content)) == \
        content
    assert splitfile.loads(text) == content
    assert splitfile.loads(yaml.dump(content)) == content
    assert splitfile.loads("cost: 12\nn: .nan\n")["cost"] == 12.0
    assert np.isnan(splitfile.loads(yaml.dump({"n": float("nan")}))["n"])
    # ordinary ids are written as yaml.dump writes them
    plain = {"train": ["0012RPI0120150401", "7", "a1"], "kind": "dissim"}
    assert splitfile.dumps(plain) == yaml.dump(plain)


@pytest.mark.parametrize("text,match", [
    ("a:\n  b: 1\n", "nested"),
    ("train:\n- 12\n", "reads as a number"),
    ("kind: yes\n", "neither a str"),
    ("cost: 0012\n", "neither a str"),
    ("train:\n", "has no value"),
    ("train: [a, b]\n", "unsupported"),
    ("- a\n", "outside a key"),
    ("a: 1\na: 2\n", "repeated"),
    ("a:b\n", "key: value"),
])
def test_split_file_reader_refuses_other_yaml(text, match):
    with pytest.raises(splitfile.SplitFileError, match=match):
        splitfile.loads(text)


@pytest.mark.parametrize("mapping,match", [
    (["a"], "mapping"), ({"a": {"b": 1}}, "not a list"),
    ({"a": [1]}, "not a str"), ({"a b": "x"}, "identifier"),
    ({"a": True}, "not a list"), ({"a": "x\ny"}, "not printable"),
])
def test_split_file_writer_refuses_other_content(mapping, match):
    with pytest.raises(splitfile.SplitFileError, match=match):
        splitfile.dumps(mapping)

