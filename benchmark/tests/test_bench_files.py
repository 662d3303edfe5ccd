"""BENCHMARK.json and the files it names: the shape its readers expect, each
cell's files parse, and a cell added as files alone is picked up."""
import json
import os
import re

import pytest

import bench_tiny
from benchmark import harness

MANIFEST = harness.read_json(bench_tiny.ROOT, "BENCHMARK.json")
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
KEYS = {
    "top": {"command", "paths", "run_seconds", "configs", "workloads",
            "end_to_end", "per_layer"},
    "configs": {"name", "source", "file", "reduced", "why"},
    "workloads": {"name", "config", "traffic", "chips", "why"},
    "end_to_end": {"name", "unit", "better", "bound", "source"},
    "per_layer": {"name", "unit", "better", "source", "layer", "moves"},
}


def test_manifest_shape():
    assert set(MANIFEST) == KEYS["top"]
    assert MANIFEST["paths"] == ["benchmark"]
    assert 1 <= MANIFEST["run_seconds"] <= 51
    for group in ("configs", "workloads", "end_to_end", "per_layer"):
        names = [e["name"] for e in MANIFEST[group]]
        assert len(names) == len(set(names))
        for entry in MANIFEST[group]:
            assert set(entry) - {"workloads"} == KEYS[group], entry
            assert NAME.match(entry["name"])
            for key in ("why", "layer", "source"):
                if key in entry:
                    assert 1 <= len(entry[key]) <= 200
                    assert "\n" not in entry[key] and "\t" not in entry[key]
    for m in MANIFEST["end_to_end"] + MANIFEST["per_layer"]:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
    for m in MANIFEST["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25
        assert m["source"] in ("host_clock", "device_trace")
    ends = {m["name"]: m for m in MANIFEST["end_to_end"]}
    cells = {w["name"]: w for w in MANIFEST["workloads"]}
    for m in MANIFEST["per_layer"]:
        moved = ends[m["moves"]]
        for cell in m["workloads"]:
            assert cell in moved.get("workloads", cells)
    for name in cells:
        assert harness.metrics_of(MANIFEST, name, False)
        assert harness.metrics_of(MANIFEST, name, True)
        assert {"setup_s"} < {m["name"] for m in
                              harness.metrics_of(MANIFEST, name, False)}
    assert len(json.dumps(MANIFEST)) < 64 * 1024


@pytest.mark.parametrize("cell", [w["name"] for w in MANIFEST["workloads"]])
def test_cell_files_parse(cell):
    entry, spec, config, traffic = harness.load_cell(cell)
    assert entry["chips"] == 1
    assert config["name"] == entry["config"]
    assert set(spec["check"]["limits"]) <= {
        "loss_gap", "first_grad_gap", "change_gap", "head_grad_diff",
        "head_free_diff", "pred_gap", "vote_gap",
        "test_loss_gap", "logit_gap", "own_loss_gap", "windows_gap",
        "steps_gap"}
    assert {"windows_gap", "steps_gap"} <= set(spec["check"]["limits"])
    assert traffic["epoch"] in ("train", "test")
    by_name = {c["name"]: c for c in MANIFEST["configs"]}
    assert by_name[entry["config"]]["file"] == os.path.join(
        "benchmark", "configs", entry["config"] + ".json")
    for m in harness.metrics_of(MANIFEST, cell, True) + harness.metrics_of(
            MANIFEST, cell, False):
        assert callable(harness.reader(m["name"]))


def test_a_new_cell_is_picked_up_from_its_files(tmp_path):
    bench, manifest = bench_tiny.tiny_bench(tmp_path)
    with open(os.path.join(bench, "traffic", "train_4_patients.json"),
              "w") as f:
        json.dump({"patients": 10, "windows": [17, 20], "fold": 1,
                   "epoch": "train"}, f)
    with open(os.path.join(bench, "workloads", "new_cell.json"), "w") as f:
        json.dump({"driver": "fold_epochs",
                   "check": {"steps": 2, "limits": {"loss_gap": 1.0}},
                   "trace": {"start_step": 0, "steps": 1}}, f)
    manifest["workloads"].append({
        "name": "new_cell", "config": "cnn_linear_densenet18_nb20",
        "traffic": "train_4_patients", "chips": 1, "why": "a test"})
    for m in manifest["end_to_end"]:
        if m["name"] == "train_windows_per_s":
            m["workloads"].append("new_cell")
    out, checked = bench_tiny.run(bench, manifest, "new_cell")
    assert out["correct"] and checked[0][0] == "loss_gap"
    assert set(out["metrics"]) == {"train_windows_per_s", "setup_s"}
