"""The host cost of the program's own measurement (``utils.profiling``).

    python -m benchmark.telemetry_cost [--spans N] [--pairs N]

prints one JSON line: microseconds per ``annotate`` span with no profiler
recording and with one recording (CPU and, on the card, CUDA
activities), per bare ``record_function`` with none recording (what a
span cost before it was gated), and, on the card, per pair of step
events (``StepEvents.begin`` and ``end`` around nothing, the ring's
resolution of older pairs included), with the card's name.
"""
import argparse
import json
import sys
import time

import torch

from deepards_tpu_torch.utils import profiling


def per_call_us(fn, n):
    t0 = time.perf_counter()
    for _ in range(n):
        fn()
    return (time.perf_counter() - t0) / n * 1e6


def span():
    with profiling.annotate("deepards.cost.span"):
        pass


def bare_record_function():
    with torch.profiler.record_function("deepards.cost.bare"):
        pass


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--spans", type=int, default=200_000)
    parser.add_argument("--pairs", type=int, default=20_000)
    args = parser.parse_args(argv)
    cuda = torch.cuda.is_available()
    out = {"device": torch.cuda.get_device_name(0) if cuda else "cpu"}
    per_call_us(span, 1000)  # warm up
    out["span_us"] = per_call_us(span, args.spans)
    out["bare_record_function_us"] = per_call_us(bare_record_function,
                                                 args.spans)
    activities = [torch.profiler.ProfilerActivity.CPU]
    if cuda:
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    n = args.spans // 10
    with torch.profiler.profile(activities=activities):
        out["span_profiled_us"] = per_call_us(span, n)
    if cuda:
        events = profiling.StepEvents()

        def pair():
            events.end(events.begin())

        per_call_us(pair, 1000)  # warm up
        torch.cuda.synchronize()
        out["step_events_pair_us"] = per_call_us(pair, args.pairs)
        out["ring_pairs"] = events.size
        # its parts: an event's record, query and elapsed_time
        a, b = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        stream = torch.cuda.current_stream()
        out["event_record_us"] = per_call_us(a.record, args.pairs)
        out["event_record_stream_us"] = per_call_us(
            lambda: a.record(stream), args.pairs)
        b.record()
        b.synchronize()
        out["event_query_us"] = per_call_us(b.query, args.pairs)
        out["event_elapsed_us"] = per_call_us(lambda: a.elapsed_time(b),
                                              args.pairs)
        out["current_stream_us"] = per_call_us(torch.cuda.current_stream,
                                                args.pairs)
    profiling.reset_totals()
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
