"""The readers of the program's own spans, counters and step events, on
synthetic traces and totals."""
import types

import pytest
from torch.autograd import DeviceType

import bench_tiny
from benchmark import harness, program_spans
from benchmark.metrics import (
    launch_idle_ms_per_step,
    pad_window_share,
    records_host_ms_per_epoch,
    stage_idle_ms_per_step,
    step_gap_ms,
    step_gap_share,
)
from benchmark.trace import DeviceTrace
from deepards_tpu_torch.utils import profiling


def _event(name, start, end, device=DeviceType.CPU):
    return types.SimpleNamespace(
        name=name, device_type=device,
        time_range=types.SimpleNamespace(start=start, end=end))


class _Profile:
    def __init__(self, events):
        self._events = events

    def events(self):
        return self._events


def _run(kernels, spans, steps=2, epochs=1):
    """A traced run: kernels [(start, end)] on the device, the host's
    spans [(name, start, end)], benchmark spans and program spans alike."""
    events = [_event(n, s, e) for n, s, e in spans] + [
        _event("k", s, e, DeviceType.CUDA) for s, e in kernels]
    trace = DeviceTrace([("k", s, e) for s, e in kernels],
                        [x for x in spans if x[0].startswith("bench.")],
                        steps)
    return types.SimpleNamespace(
        trace=trace, clock=types.SimpleNamespace(profile=_Profile(events)),
        counters={"epochs": epochs})


# two steps over 0..100 us; kernels overlap on two streams
KERNELS = [(0.0, 30.0), (20.0, 40.0), (60.0, 80.0), (70.0, 100.0)]
SPANS = [("bench.trainer.epoch", -5.0, 105.0),
         ("deepards.trainer.stage", -5.0, 2.0),
         ("bench.runner.train", 2.0, 45.0),
         ("deepards.step.run", 3.0, 44.0),
         ("host", 45.0, 50.0),  # neither program span
         ("deepards.trainer.stage", 50.0, 55.0),
         ("bench.runner.train", 55.0, 65.0),
         ("deepards.step.run", 56.0, 64.0)]


def test_overlapping_kernels_leave_one_idle_interval():
    run = _run(KERNELS, SPANS)
    assert program_spans.idle(run.trace) == [(40.0, 60.0)]


def test_idle_under_the_program_spans():
    run = _run(KERNELS, SPANS)
    # the idle 40..60: the step spans (nested in bench.runner.train) to 44
    # and from 56, the host alone 45..50 in neither, the stage 50..55
    assert launch_idle_ms_per_step.read(run) == pytest.approx(8.0e-3 / 2)
    assert stage_idle_ms_per_step.read(run) == pytest.approx(5.0e-3 / 2)
    stretch_idle = run.trace.window_us - run.trace.busy_us
    assert (launch_idle_ms_per_step.read(run) + stage_idle_ms_per_step.read(
        run)) * 2 <= stretch_idle * 1e-3


def test_spans_outside_the_stretch_count_nothing():
    # the first stage span starts before the stretch's first kernel, where
    # no idle is counted
    run = _run([(0.0, 10.0), (20.0, 30.0)],
               [("deepards.trainer.stage", -50.0, 0.0),
                ("deepards.trainer.stage", 12.0, 15.0),
                ("deepards.step.run", 30.0, 60.0)], steps=1)
    assert stage_idle_ms_per_step.read(run) == pytest.approx(3.0e-3)
    assert launch_idle_ms_per_step.read(run) == 0.0


def test_overlapping_spans_count_once():
    run = _run([(0.0, 10.0), (40.0, 50.0)],
               [("deepards.step.run", 10.0, 30.0),
                ("deepards.step.run", 20.0, 35.0)], steps=1)
    assert launch_idle_ms_per_step.read(run) == pytest.approx(25.0e-3)


def test_a_device_span_of_the_name_is_not_the_hosts():
    run = _run([(0.0, 10.0), (40.0, 50.0)], [("deepards.step.run", 12.0,
                                               14.0)], steps=1)
    run.clock.profile._events.append(
        _event("deepards.step.run", 10.0, 40.0, DeviceType.CUDA))
    assert launch_idle_ms_per_step.read(run) == pytest.approx(2.0e-3)


@pytest.mark.parametrize("reader", [stage_idle_ms_per_step,
                                    launch_idle_ms_per_step])
def test_idle_readers_need_a_trace_a_card_and_spans(reader):
    run = _run(KERNELS, SPANS)
    run.trace = None
    assert reader.read(run) is None  # no trace
    run = _run(KERNELS, SPANS)
    run.clock.profile = None
    assert reader.read(run) is None
    run = _run([], SPANS)
    assert reader.read(run) is None  # no card: no kernel
    run = _run(KERNELS, [x for x in SPANS if x[0].startswith("bench.")])
    assert reader.read(run) is None  # a program without the spans


TOTALS = {"spans": {"deepards.records.flush": {"seconds": 0.3, "count": 1},
                    "deepards.step.run": {"seconds": 0.1, "count": 40}},
          "counters": {"windows.real": 1300, "windows.pad": 748},
          "device": {"step.device": {"seconds": 8.0, "count": 20},
                     "step.gap": {"seconds": 0.019, "count": 19}}}


def test_totals_readers(monkeypatch):
    monkeypatch.setattr(profiling, "totals", lambda: TOTALS)
    run = types.SimpleNamespace(counters={"epochs": 3})
    assert step_gap_ms.read(run) == pytest.approx(1.0)
    # a mean gap of 1 ms before a mean step of 400 ms
    assert step_gap_share.read(run) == pytest.approx(100.0 * 1.0 / 401.0)
    assert pad_window_share.read(run) == pytest.approx(
        100.0 * 748 / 2048)
    assert records_host_ms_per_epoch.read(run) == pytest.approx(100.0)


def test_dropped_step_events_are_flagged(monkeypatch, capsys):
    dropped = dict(TOTALS, counters=dict(TOTALS["counters"],
                                         **{"step.events_dropped": 2}))
    monkeypatch.setattr(profiling, "totals", lambda: dropped)
    run = types.SimpleNamespace(counters={"epochs": 3})
    assert step_gap_ms.read(run) == pytest.approx(1.0)
    assert "2 pairs dropped" in capsys.readouterr().err
    monkeypatch.setattr(profiling, "totals", lambda: TOTALS)
    assert step_gap_share.read(run) > 0.0
    assert capsys.readouterr().err == ""


@pytest.mark.parametrize("reader", [step_gap_ms, step_gap_share,
                                    pad_window_share,
                                    records_host_ms_per_epoch])
def test_totals_readers_need_the_programs_totals(monkeypatch, reader):
    run = types.SimpleNamespace(counters={"epochs": 3})
    # a run on the CPU (no step events), or with nothing counted
    monkeypatch.setattr(profiling, "totals", lambda: {
        "spans": {}, "counters": {}, "device": {}})
    assert reader.read(run) is None
    # a program without totals
    monkeypatch.delattr(profiling, "totals")
    assert reader.read(run) is None


def test_no_epoch_no_records_reading(monkeypatch):
    monkeypatch.setattr(profiling, "totals", lambda: TOTALS)
    assert records_host_ms_per_epoch.read(
        types.SimpleNamespace(counters={"epochs": 0})) is None


CELLS = [w["name"] for w in harness.read_json(
    bench_tiny.ROOT, "BENCHMARK.json")["workloads"]]
# the metrics that read the program's own spans, counters and events, and
# of them those a CPU run has something for: no device trace and no step
# events there
PROGRAM_METRICS = ("step_gap_ms", "step_gap_share", "stage_idle_ms_per_step",
                   "launch_idle_ms_per_step", "pad_window_share",
                   "records_host_ms_per_epoch")
READ_ON_THE_CPU = ("pad_window_share", "records_host_ms_per_epoch")


def _program(names):
    return {n for n in names if n.split(".")[0] in PROGRAM_METRICS}


@pytest.fixture(scope="module")
def tiny(tmp_path_factory):
    return bench_tiny.tiny_bench(tmp_path_factory.mktemp("bench"))


@pytest.mark.parametrize("cell", CELLS)
def test_a_traced_run_on_the_cpu_reports_the_programs_counts(tiny, cell):
    profiling.reset_totals()
    out, _ = bench_tiny.run(*tiny, cell, traced=True)
    want = _program(m["name"] for m in harness.metrics_of(tiny[1], cell,
                                                          True))
    assert _program(out["metrics"]) == {
        n for n in want if n.split(".")[0] in READ_ON_THE_CPU}
    got = {k: v["value"] for k, v in out["metrics"].items()}
    if "pad_window_share.train" in got:
        assert 0.0 < got["pad_window_share.train"] < 100.0
    if "records_host_ms_per_epoch.eval" in got:
        assert got["records_host_ms_per_epoch.eval"] == pytest.approx(
            got["records_ms_per_epoch.eval"], rel=0.2)
