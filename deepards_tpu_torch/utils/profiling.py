"""Profiling and tracing utilities.

Counterpart of ``deepards_tpu/utils/profiling.py`` (the reference had no
built-in profiling, SURVEY.md §5.1): a step timer that reports
steady-state throughput, ``trace`` around any code for a Chrome trace of
``torch.profiler`` (host ops and, on the card, CUDA kernels), and
``annotate`` for a named span in it.

On the card ``StepTimer.tick()`` reads the host clock, so it times the
dispatch of a step unless the caller synchronizes
(``torch.cuda.synchronize()``) before each tick.
"""
import contextlib
import os
import tempfile
import time

import torch


class StepTimer:
    """Rolling per-step wall-time + throughput meter."""

    def __init__(self, warmup=2):
        self.warmup = warmup
        self.times = []
        self._last = None

    def tick(self):
        now = time.perf_counter()
        if self._last is not None:
            self.times.append(now - self._last)
        self._last = now

    @property
    def steady_times(self):
        return self.times[self.warmup:]

    def mean_step_time(self):
        t = self.steady_times
        return sum(t) / len(t) if t else float("nan")

    def throughput(self, items_per_step):
        mt = self.mean_step_time()
        return items_per_step / mt if mt and mt == mt else 0.0

    def report(self, items_per_step=None):
        out = {
            "steps": len(self.times),
            "mean_step_ms": self.mean_step_time() * 1e3,
        }
        if items_per_step:
            out["items_per_sec"] = self.throughput(items_per_step)
        return out


@contextlib.contextmanager
def trace(log_dir=None):
    """Profile the block with ``torch.profiler`` (the CPU, and CUDA when a
    card is present) and write ``log_dir/trace.json``, a Chrome trace;
    yields that path."""
    if log_dir is None:
        log_dir = os.path.join(tempfile.gettempdir(),
                               "deepards_tpu_torch_trace")
    os.makedirs(log_dir, exist_ok=True)
    path = os.path.join(log_dir, "trace.json")
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    with torch.profiler.profile(activities=activities) as prof:
        yield path
    prof.export_chrome_trace(path)


def annotate(name):
    """Named trace span for profiler timelines."""
    return torch.profiler.record_function(name)
