"""The port's own spans, counters and step events
(``deepards_tpu_torch.utils.profiling``), on the CPU, and the step events
of graph replays on the card.

The file imports no JAX, so its card test runs on a machine with the card
but without JAX:

    python -m pytest tests/test_torch_telemetry.py -m cuda --noconftest -q

A small device-cache train epoch and test epoch of ``Trainer``
(cnn_linear/densenet18 at S = 2, batch 4, float32) run on the CPU under
``torch.profiler`` and without it.
"""
import os
import types

import numpy as np
import pytest
import torch

from deepards_tpu_torch.config.config import Configuration
from deepards_tpu_torch.data.dataset import ARDSRawDataset
from deepards_tpu_torch.data.windowing import WindowCache
from deepards_tpu_torch.models import densenet1d, heads
from deepards_tpu_torch.models.nested import bucket
from deepards_tpu_torch.train import loop
from deepards_tpu_torch.train.losses import bce_with_logits
from deepards_tpu_torch.train.nested_trainer import NestedTrainer
from deepards_tpu_torch.train.steps import (
    StepRunner,
    TrainState,
    make_optimizer,
    make_train_step,
)
from deepards_tpu_torch.utils import profiling

torch.set_num_threads(1)

S, BATCH = 2, 4
WINDOWS = (9, 12, 10, 11)  # a patient's windows, classes alternating

FLAGS = dict(
    network="cnn_linear", base_network="densenet18",
    dataset_type="unpadded_centered_sequences", n_sub_batches=S,
    batch_size=BATCH, kfolds=2, oversample_minority=True, loss_func="bce",
    clip_grad=True, clip_val=0.01, optimizer="sgd", learning_rate=0.001,
    weight_decay=0.0001, compute_dtype="float32", defer_fetch=True,
    dp_devices=1, seed=3)


@pytest.fixture(autouse=True)
def fresh_totals():
    profiling.reset_totals()
    yield
    profiling.reset_totals()


def _datasets(tmp_path):
    """(train, test) views of fold 0 over four patients of random
    windows."""
    rng = np.random.default_rng(0)
    n = sum(WINDOWS)
    names = [str(k + 1) for k in range(len(WINDOWS))]
    ys = np.repeat(np.arange(len(WINDOWS)) % 2, WINDOWS)
    cache = WindowCache(
        data=rng.normal(size=(n, S, 1, 224)).astype(np.float32),
        target=np.eye(2, dtype=np.float32)[ys],
        hours=np.concatenate([np.arange(k * S, dtype=np.float32).reshape(
            k, S) for k in WINDOWS]) / 1200.0,
        patient_idx=np.repeat(np.arange(len(WINDOWS)),
                              WINDOWS).astype(np.int32),
        patients=names)
    path = os.path.join(str(tmp_path), "cohort.csv")
    with open(path, "w") as f:
        f.write("Patient Unique Identifier,Pathophysiology\n")
        f.writelines("{},{}\n".format(p, "ARDS" if k % 2 else "OTHER")
                     for k, p in enumerate(names))
    conf = Configuration(overrides=dict(
        FLAGS, results_dir=os.path.join(str(tmp_path), "results")))
    train = ARDSRawDataset(str(tmp_path), 1, path, S, conf.dataset_type,
                           cache=cache, kfold_num=0, total_kfolds=2,
                           oversample_minority=True, seed=conf.seed)
    return conf, train, ARDSRawDataset.make_test_dataset_if_kfold(train)


@pytest.fixture(scope="module")
def fold(tmp_path_factory):
    """(trainer, runner, train split, test split) of fold 0 on the CPU."""
    conf, train, test = _datasets(tmp_path_factory.mktemp("telemetry"))
    trainer = loop.Trainer(conf, device="cpu", verbose=False)
    trainer.n_sub_batches = S
    trainer.in_channels = 1
    state = trainer.fold_state(0)
    steps = make_train_step(trainer.loss_fn, **trainer.step_options(train))
    runner = trainer.make_runner(state, train, *steps)
    return trainer, runner, train, test


def _epochs(trainer, runner, train, test):
    with trainer.deferred_fetch():
        trainer.run_train_epoch(runner, train, 0, 1)
        trainer.run_test_epoch(runner, test, 0, 1)


def _steps(dataset):
    return -(-len(dataset.current_indices()) // BATCH)


def test_annotate_enters_no_record_function_without_a_profiler(monkeypatch):
    def refused(name):
        raise AssertionError("record_function entered for " + name)

    monkeypatch.setattr(torch.profiler, "record_function", refused)
    for _ in range(3):
        with profiling.annotate("deepards.test.span"):
            pass
    profiling.count("test.counter", 5)
    profiling.count("test.counter")
    got = profiling.totals()
    assert got["spans"]["deepards.test.span"]["count"] == 3
    assert got["spans"]["deepards.test.span"]["seconds"] >= 0.0
    assert got["counters"] == {"test.counter": 6}


def test_annotate_is_in_the_profilers_timeline():
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        with profiling.annotate("deepards.test.traced"):
            torch.ones(8).sum()
    names = [e.name for e in prof.events()]
    assert names.count("deepards.test.traced") == 1
    assert profiling.totals()["spans"]["deepards.test.traced"]["count"] == 1


def test_epochs_under_the_profiler_emit_a_span_a_step(fold):
    trainer, runner, train, test = fold
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        _epochs(trainer, runner, train, test)
    names = [e.name for e in prof.events() if e.name.startswith("deepards.")]
    steps = _steps(train) + _steps(test)
    assert names.count("deepards.trainer.stage") == steps
    assert names.count("deepards.step.run") == steps
    assert names.count("deepards.records.flush") == 1
    spans = profiling.totals()["spans"]
    assert spans["deepards.trainer.stage"]["count"] == steps
    assert spans["deepards.step.run"]["count"] == steps
    assert spans["deepards.records.flush"]["count"] == 1


def test_epoch_windows_are_the_masks_sums(fold):
    trainer, runner, train, test = fold
    _epochs(trainer, runner, train, test)
    real = pad = 0
    for ds in (train, test):
        _, masks = loop._epoch_order(np.asarray(ds.current_indices()), BATCH)
        real += int(masks.sum())
        pad += int((1 - masks).sum())
    assert pad > 0
    assert profiling.totals()["counters"] == {"windows.real": real,
                                              "windows.pad": pad}


def test_host_epoch_windows_are_the_masks_sums(fold):
    trainer, runner, train, test = fold
    trainer.conf.conf["device_cache"] = False
    try:
        _epochs(trainer, runner, train, test)
    finally:
        del trainer.conf.conf["device_cache"]
    real = len(train.current_indices()) + len(test.current_indices())
    got = profiling.totals()["counters"]
    assert got["windows.real"] == real
    assert got["windows.pad"] == BATCH * (_steps(train) + _steps(test)) - real
    spans = profiling.totals()["spans"]
    assert spans["deepards.trainer.stage"]["count"] == (
        _steps(train) + _steps(test))


def test_on_the_cpu_the_step_events_stay_empty(fold):
    _epochs(*fold)
    got = profiling.totals()
    assert got["device"] == {}
    assert profiling.step_events.recorded == 0


def test_reset_totals_zeroes_them(fold):
    _epochs(*fold)
    assert profiling.totals()["counters"]
    profiling.reset_totals()
    assert profiling.totals() == {"spans": {}, "counters": {}, "device": {}}


class _Runner:
    """A bucket's runner that only holds its buffers."""

    def __init__(self, size):
        self.inputs = {"data": torch.zeros(1, size, S, 1, 224),
                       "target": torch.zeros(1, 2),
                       "mask": torch.zeros(1, size)}

    def train(self):
        return torch.zeros(())


def test_nested_patient_steps_count_windows_and_bucket_pad(tmp_path):
    conf = Configuration(overrides=dict(
        FLAGS, network="cnn_to_nested_lstm", batch_size=1,
        results_dir=str(tmp_path / "results")))
    trainer = NestedTrainer(conf, device="cpu", verbose=False)
    sizes = (5, 9, 16, 33)
    n = sum(sizes)
    cache = types.SimpleNamespace(
        token="nested", data=np.zeros((n, S, 1, 224), np.float32),
        target=np.zeros((n, 2), np.float32))
    groups, start = [], 0
    for k, w in enumerate(sizes):
        groups.append((str(k), np.arange(start, start + w), k % 2))
        start += w
    runners = {}
    for w in sizes:
        runners.setdefault(bucket(w), _Runner(bucket(w)))
    trainer.patient_steps(runners, types.SimpleNamespace(cache=cache),
                          groups, train=True)
    got = profiling.totals()
    assert got["counters"] == {
        "windows.real": sum(sizes),
        "windows.pad": sum(bucket(w) - w for w in sizes)}
    assert got["spans"]["deepards.trainer.stage"]["count"] == len(sizes)


class _FakeEvent:
    """A timing event on a pretend device clock: it completes once the
    clock has passed the time it was recorded at."""

    clock = {"now": 0.0, "done": 0.0}
    made = 0

    def __init__(self, enable_timing=False):
        type(self).made += 1
        self.at = None

    def record(self, stream=None):
        self.at = self.clock["now"]

    def query(self):
        return self.at is not None and self.at <= self.clock["done"]

    def synchronize(self):
        self.clock["done"] = max(self.clock["done"], self.at)

    def elapsed_time(self, end):
        assert self.query() and end.query()
        return end.at - self.at


def _fake_events(monkeypatch):
    monkeypatch.setattr(torch.cuda, "Event", _FakeEvent)
    monkeypatch.setattr(torch.cuda, "current_stream", lambda: None)


def test_step_event_ring_sums_steps_and_gaps(monkeypatch):
    """Steps of 3 ms with 1 ms between them, the device keeping up: the
    ring of 4 resolves as it wraps, and a profiled step breaks the
    chain of gaps."""
    _fake_events(monkeypatch)
    clock = _FakeEvent.clock
    clock.update(now=0.0, done=0.0)
    _FakeEvent.made = 0
    ring = profiling.StepEvents(size=4)

    def step():
        pair = ring.begin()
        clock["now"] += 3.0
        ring.end(pair)
        clock["now"] += 1.0
        clock["done"] = clock["now"]

    for _ in range(10):
        step()
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]):
        step()  # left out
    for _ in range(5):
        step()
    assert len(ring.slots) == 4 and _FakeEvent.made <= 2 * 4 + 2
    got = ring.totals()
    assert got["step.device"]["count"] == 15
    assert got["step.device"]["seconds"] == pytest.approx(15 * 3e-3)
    # 9 gaps in the first ten steps; the first after the profiled one has
    # none (its gap would hold the profiled step); 4 among the last five
    assert got["step.gap"]["count"] == 13
    # the gap across the profiled step is not counted: 1 ms each
    assert got["step.gap"]["seconds"] == pytest.approx(13 * 1e-3)


def test_step_event_totals_leave_the_chain_open(monkeypatch):
    """Totals read between steps count the open chain's steps without
    ending it: the steps after them keep their gaps."""
    _fake_events(monkeypatch)
    clock = _FakeEvent.clock
    clock.update(now=0.0, done=0.0)
    ring = profiling.StepEvents(size=4)
    seen = []
    for i in range(12):
        pair = ring.begin()
        clock["now"] += 2.0
        ring.end(pair)
        clock["now"] += 0.5
        clock["done"] = clock["now"]
        if i in (5, 6):
            seen.append(ring.totals())
    assert seen[0]["step.device"] == {"seconds": pytest.approx(6 * 2e-3),
                                      "count": 6}
    assert seen[1]["step.device"]["count"] == 7
    got = ring.totals()
    assert got["step.device"] == {"seconds": pytest.approx(12 * 2e-3),
                                  "count": 12}
    assert got["step.gap"] == {"seconds": pytest.approx(11 * 0.5e-3),
                               "count": 11}


def test_step_event_ring_drops_a_pair_it_would_wait_for(monkeypatch):
    _fake_events(monkeypatch)
    clock = _FakeEvent.clock
    clock.update(now=0.0, done=-1.0)
    ring = profiling.StepEvents(size=4)
    for _ in range(6):  # the device has finished nothing
        ring.end(ring.begin())
        clock["now"] += 2.0
    assert profiling.totals()["counters"] == {"step.events_dropped": 2}
    got = ring.totals()  # waits for the rest
    assert got["step.device"]["count"] == 4
    assert got["step.gap"]["count"] == 3


def _graph_runner(dev):
    """A graphed runner of cnn_linear/densenet18 at S = 2, batch 4."""
    model = heads.CNNLinearNetwork(densenet1d.densenet18(), S)
    model.reset_parameters(torch.Generator().manual_seed(0))
    model.to(dev)
    state = TrainState(model, make_optimizer(model.parameters()),
                       torch.Generator(device=dev).manual_seed(1))
    train_step, eval_step = make_train_step(bce_with_logits)
    return StepRunner(state, train_step, eval_step, (BATCH, S, 1, 224),
                      graphed=True)


@pytest.mark.cuda
def test_graph_replays_resolve_step_events_without_a_sync(monkeypatch):
    """300 graphed steps: the ring (32 pairs, paced by the test's own
    stream waits every 16 steps so no pair is dropped) resolves the graph
    time and the gaps without a synchronize on the step path, and holds
    no more events than its slots and the two ends of a chain."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (graph capture has no CPU mode)")
    dev = torch.device("cuda")
    runner = _graph_runner(dev)
    ring = profiling.StepEvents(size=32)
    monkeypatch.setattr(profiling, "step_events", ring)
    made = []
    event = torch.cuda.Event

    def counted(*args, **kwargs):
        made.append(1)
        return event(*args, **kwargs)

    def refused(*args, **kwargs):
        raise AssertionError("a synchronize on the step path")

    stream = torch.cuda.current_stream()
    data = torch.randn(300, BATCH, S, 1, 224, device=dev)
    outer = [event(enable_timing=True) for _ in range(2)]
    outer[0].record(stream)
    with monkeypatch.context() as patch:
        patch.setattr(torch.cuda, "Event", counted)
        patch.setattr(torch.cuda, "synchronize", refused)
        patch.setattr(event, "synchronize", refused)
        for i in range(300):
            runner.inputs["data"].copy_(data[i])
            torch.cuda.set_sync_debug_mode("error")
            try:
                runner.train()
            finally:
                torch.cuda.set_sync_debug_mode(0)
            if i % 16 == 15:
                stream.synchronize()
    outer[1].record(stream)
    assert len(ring.slots) == 32 and len(made) <= 2 * 32 + 2
    assert ring.resolved == 300 - 32
    got = ring.totals()
    assert got["step.device"]["count"] == 300
    assert got["step.gap"]["count"] == 299
    assert got["step.device"]["seconds"] > 0.0
    assert got["step.gap"]["seconds"] >= 0.0
    # the steps and the gaps between them lie within the loop's own pair
    outer[1].synchronize()
    steps_and_gaps = got["step.device"]["seconds"] + got["step.gap"][
        "seconds"]
    assert steps_and_gaps <= outer[0].elapsed_time(outer[1]) * 1e-3 + 1e-5
    assert "step.events_dropped" not in profiling.totals()["counters"]
