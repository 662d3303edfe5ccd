"""Device busy time from the union of kernel intervals."""
import pytest

import bench_tiny  # noqa: F401
from benchmark.trace import RUNTIME, DeviceTrace, merge


def test_merge():
    assert merge([(5, 7), (0, 2), (1, 3), (6, 9)]) == [(0, 3), (5, 9)]


def test_overlapping_kernels_give_a_share_in_range():
    # two streams' kernels overlap: their summed time exceeds the stretch
    kernels = [("a", 0.0, 60.0), ("b", 10.0, 70.0), ("c", 30.0, 90.0),
               ("d", 95.0, 100.0)]
    trace = DeviceTrace(kernels, [("bench.runner.train", 0.0, 100.0)], 2)
    summed = sum(e - s for _, s, e in kernels)
    assert 1.0 - summed / trace.window_us < 0  # the old reading
    assert trace.busy_us == 95.0
    assert trace.idle_share() == pytest.approx(0.05)
    assert 0.0 <= trace.idle_share() <= 1.0


def test_idle_gaps_name_the_host_span():
    kernels = [("a", 0.0, 10.0), ("b", 40.0, 50.0), ("c", 52.0, 60.0)]
    spans = [("bench.trainer.epoch", 0.0, 60.0),
             ("bench.runner.train", 45.0, 55.0)]
    trace = DeviceTrace(kernels, spans, 2)
    gaps = trace.idle_gaps()
    assert [g[0] for g in gaps] == ["bench.trainer.epoch",
                                    "bench.runner.train"]
    assert [g[1] for g in gaps] == pytest.approx([30e-6, 2e-6])
    (name, seconds), = trace.top_kernels(1)
    assert name == "a" and seconds == pytest.approx(10e-6)


def test_trainer_host_time_leaves_out_runtime_waits():
    # three runner calls, two gaps of 20 us; in the first gap the host
    # waits 15 us in a copy, the row count takes 1 us of each gap
    spans = [("bench.trainer.epoch", 0.0, 100.0),
             ("bench.runner.train", 10.0, 30.0),
             ("bench.count", 30.0, 31.0),
             ("bench.runner.train", 50.0, 70.0),
             ("bench.count", 70.0, 71.0),
             ("bench.runner.train", 90.0, 95.0)]
    runtime = [(32.0, 47.0), (55.0, 56.0), (5.0, 8.0)]
    trace = DeviceTrace([("k", 0.0, 100.0)], spans, 3, runtime)
    assert trace.trainer_host_us() == pytest.approx((4.0 + 19.0) / 2)
    assert DeviceTrace([], spans[:2], 1).trainer_host_us() is None


@pytest.mark.parametrize("name,runtime", [
    ("cudaLaunchKernel", True), ("cudaGraphLaunch", True),
    ("cudaMemcpyAsync", True), ("cuLaunchKernel", True),
    ("cudaStreamSynchronize", True), ("aten::copy_", False),
    ("cutlass_gemm", False), ("bench.count", False)])
def test_runtime_calls_by_name(name, runtime):
    assert bool(RUNTIME.match(name)) is runtime
