"""The check decides ``correct``: a sound run passes, a run with its
timed path broken underneath fails, and the control (the reference in
float8 in the program's place) fails the cell's limits.  At a cut size on
the CPU, the program in float32."""
import json
import os
import subprocess
import sys

import pytest
import torch

import bench_tiny
from benchmark import calibrate, harness
from deepards_tpu_torch.train import loop, losses
from deepards_tpu_torch.train.nested_trainer import NestedTrainer
from deepards_tpu_torch.train.steps import ClippedOptimizer, StepRunner

CELLS = [w["name"] for w in harness.read_json(
    bench_tiny.ROOT, "BENCHMARK.json")["workloads"]]
TRAIN = ["cnn_linear_train", "nested_lstm_train"]


@pytest.fixture(scope="module")
def tiny(tmp_path_factory):
    return bench_tiny.tiny_bench(tmp_path_factory.mktemp("bench"))


@pytest.mark.parametrize("cell", CELLS)
def test_a_sound_run_is_correct(tiny, cell):
    out, checked = bench_tiny.run(*tiny, cell)
    assert out["correct"], checked
    assert out["attempted"] > 0 and out["failed"] == 0


@pytest.mark.parametrize("cell", CELLS)
def test_a_traced_run_reports_its_layers(tiny, cell):
    out, _ = bench_tiny.run(*tiny, cell, traced=True)
    want = {m["name"] for m in harness.metrics_of(tiny[1], cell, True)}
    # the CPU has no device trace and no peak: those metrics stay silent
    silent = {n for n in want if n.split(".")[0] in (
        "step_device_ms", "launches_per_step", "device_idle_share",
        "peak_memory_gb", "mfu", "step_gap_ms", "step_gap_share",
        "stage_idle_ms_per_step", "launch_idle_ms_per_step")}
    assert set(out["metrics"]) == want - silent


def unchanged_state(monkeypatch):
    """The optimizer's step leaves the state as it was."""
    monkeypatch.setattr(ClippedOptimizer, "step", lambda self: None)


def half_the_batch(monkeypatch):
    """The loss's mean taken over the first half of the rows only."""
    bce = losses.bce_with_logits

    def first_half(logits, target, weights=None):
        if weights is None:
            weights = torch.ones(logits.shape[0], device=logits.device)
        keep = torch.ones_like(weights)
        keep[logits.shape[0] - logits.shape[0] // 2:] = 0.0
        return bce(logits, target, weights * keep)

    monkeypatch.setattr(losses, "bce_with_logits", first_half)


def altered_answers(monkeypatch):
    """Every test step's logits negated where the step produces them."""
    evaluate = StepRunner.eval

    def negated(self):
        loss, out = evaluate(self)
        return loss, -out

    monkeypatch.setattr(StepRunner, "eval", negated)


def skipped_step(monkeypatch):
    """Each device-cache train epoch, and each nested epoch, leaves out
    its last step."""
    device_steps = loop.Trainer._device_steps
    patient_steps = NestedTrainer.patient_steps

    def fewer(self, runner, dataset, ids, masks, train):
        if train:
            ids, masks = ids[:-1], masks[:-1]
        return device_steps(self, runner, dataset, ids, masks, train)

    def fewer_patients(self, runners, dataset, groups, train):
        return patient_steps(self, runners, dataset, groups[:-1], train)

    def record_fewer(self, losses, outs, groups, *rest):
        return record(self, losses, outs, groups[:len(outs)], *rest)

    record = NestedTrainer._record_nested_eval
    monkeypatch.setattr(loop.Trainer, "_device_steps", fewer)
    monkeypatch.setattr(NestedTrainer, "patient_steps", fewer_patients)
    monkeypatch.setattr(NestedTrainer, "_record_nested_eval", record_fewer)


def pad_rows_real(monkeypatch):
    """An epoch's last batch is filled with repeated rows that its mask
    counts as real."""
    order = loop._epoch_order

    def all_real(idx, batch_size):
        ids, masks = order(idx, batch_size)
        return ids, masks * 0 + 1

    monkeypatch.setattr(loop, "_epoch_order", all_real)


def halved_mask(monkeypatch):
    """Each step's mask keeps the first half of its real rows."""
    train, evaluate = StepRunner.train, StepRunner.eval

    def halve(runner):
        mask = runner.inputs["mask"].reshape(-1)
        real = int(mask.sum())
        mask[real - real // 2:real] = 0.0

    def halved_train(self):
        halve(self)
        return train(self)

    def halved_eval(self):
        halve(self)
        return evaluate(self)

    monkeypatch.setattr(StepRunner, "train", halved_train)
    monkeypatch.setattr(StepRunner, "eval", halved_eval)


# the faults each cell can have.  A nested step's batch is one patient's
# windows: ``half_the_batch`` keeps its bucket's first half of rows in the
# loss, ``halved_mask`` the first half of its real windows in the mask
FAULTS = [("cnn_linear_train", unchanged_state),
          ("cnn_linear_train", half_the_batch),
          ("cnn_linear_train", skipped_step),
          ("cnn_linear_train", pad_rows_real),
          ("cnn_linear_train", halved_mask),
          ("nested_lstm_train", unchanged_state),
          ("nested_lstm_train", half_the_batch),
          ("nested_lstm_train", halved_mask),
          ("nested_lstm_train", skipped_step),
          ("cnn_linear_eval", altered_answers),
          ("cnn_linear_eval", half_the_batch),
          ("cnn_linear_eval", pad_rows_real),
          ("cnn_linear_eval", halved_mask),
          ("nested_lstm_eval", altered_answers),
          ("nested_lstm_eval", half_the_batch),
          ("nested_lstm_eval", halved_mask),
          ("nested_lstm_eval", skipped_step)]


@pytest.mark.parametrize("cell,fault", FAULTS)
def test_a_broken_timed_path_is_not_correct(tiny, monkeypatch, cell, fault):
    fault(monkeypatch)
    out, checked = bench_tiny.run(*tiny, cell)
    assert not out["correct"], checked


@pytest.fixture(scope="module")
def wide(tmp_path_factory):
    """The cut copy with the cells' 20 breaths a window and batch of 16:
    the head's first gradient as wide as the cells', and clamped as
    theirs, for the numbers read from it."""
    return bench_tiny.tiny_bench(tmp_path_factory.mktemp("wide"),
                                 breaths=20, batch=16)


# cells whose control is read at the cells' widths: cnn_linear_train's
# ``head_free_diff`` needs the head's elements under the clamp, of which
# the 2-breath copy has too few
WIDE = {"cnn_linear_train"}


@pytest.mark.parametrize("cell", CELLS)
def test_the_control_fails_the_limits(request, cell):
    bench, manifest = request.getfixturevalue(
        "wide" if cell in WIDE else "tiny")
    limits = harness.load_cell(cell)[1]["check"]["limits"]
    got = dict(calibrate.readings(cell, 2 ** 31 + 5, False, True, "cpu",
                                  bench, manifest))
    # the counts are the window's, which a control does not run
    compared = [k for k in limits if k in got["control"]]
    assert any(got["control"][k] > limits[k] for k in compared), got
    if (cell, half_the_batch) in FAULTS:
        assert any(got["half"][k] > limits[k] for k in compared), got


def test_no_card_no_result():
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    proc = subprocess.run(
        [sys.executable, os.path.join(bench_tiny.ROOT, "benchmark", "run.py"),
         "--workload", "cnn_linear_train", "--seed", "1", "--seconds", "1"],
        capture_output=True, text=True, timeout=300)
    assert proc.returncode != 0 and proc.stdout == ""


@pytest.mark.cuda
def test_a_short_run_on_the_card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card")
    proc = subprocess.run(
        [sys.executable, os.path.join(bench_tiny.ROOT, "benchmark", "run.py"),
         "--workload", "cnn_linear_train", "--seed", str(2 ** 31 + 3),
         "--seconds", "1"], capture_output=True, text=True, timeout=600)
    assert proc.returncode == 0, proc.stderr[-2000:]
    assert json.loads(proc.stdout.splitlines()[-1])["correct"]
