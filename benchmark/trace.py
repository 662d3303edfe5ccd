"""The benchmark's own spans and its trace of the device.

``StepClock`` counts the runner's calls and, on the device, the real
rows of the steps (the sum of the mask the trainer gave each step); it
also runs the hooks set for a call once that call has returned.
``RunnerProbe`` and ``BucketProbe`` wrap the runner (or a nested fold's
bucket runners) that the harness hands to the trainer, so every step the
trainer takes passes through them.  In a traced run the clock also runs
``torch.profiler`` over a stretch of consecutive steps (the cell's
``trace``: the step it starts at and how many), synchronizing the device
at both ends, and reduces it to a ``DeviceTrace``: the kernels'
intervals, the host's calls into the CUDA runtime and the benchmark's
host spans (``bench.*``) on one clock.

Device busy time is the length of the union of the kernel intervals, so
kernels that overlap count once; the idle share is the rest of the
stretch.  The trainer's host time is what lies between the runner's
calls less the host's calls into the CUDA runtime, in which the host
waits whenever the device is behind (a full launch queue, a copy from
pageable memory), and less the benchmark's own row count.
"""
import contextlib
import re
import time

import torch

# a call into the CUDA runtime or driver, as the profiler names it
RUNTIME = re.compile(r"^cu(da)?[A-Z]")


def merge(intervals):
    """The union of (start, end) intervals as sorted disjoint ones."""
    out = []
    for start, end in sorted(intervals):
        if out and start <= out[-1][1]:
            if end > out[-1][1]:
                out[-1][1] = end
        else:
            out.append([start, end])
    return [tuple(iv) for iv in out]


def clip(intervals, lo, hi):
    return [(max(a, lo), min(b, hi)) for a, b in intervals
            if min(b, hi) > max(a, lo)]


class DeviceTrace:
    """A traced stretch: ``kernels`` [(name, start, end)] and ``spans``
    [(name, start, end)] in microseconds on the profiler's clock, and the
    runner ``steps`` it covers.  The stretch runs from the first kernel's
    start to the last one's end: the device waits on the synchronization
    that opens the stretch before its first kernel, which is the
    profiler's doing and not the program's."""

    def __init__(self, kernels, spans, steps, runtime=()):
        self.kernels = kernels
        self.spans = spans
        self.steps = steps
        self.runtime = list(runtime)
        self.start = min([s for _, s, _ in kernels], default=0.0)
        self.end = max([e for _, _, e in kernels], default=self.start)

    @property
    def window_us(self):
        return self.end - self.start

    def busy(self):
        return clip(merge([(s, e) for _, s, e in self.kernels]),
                    self.start, self.end)

    @property
    def busy_us(self):
        return sum(e - s for s, e in self.busy())

    def idle_share(self):
        if self.window_us <= 0:
            return None
        return 1.0 - self.busy_us / self.window_us

    def trainer_host_us(self):
        """The host's time between consecutive runner calls, less its
        calls into the CUDA runtime and the benchmark's row count, a
        step; None with fewer than two calls."""
        runner = [(s, e) for name, s, e in self.spans
                  if name.startswith("bench.runner.")]
        if len(runner) < 2:
            return None
        lo, hi = min(s for s, _ in runner), max(e for _, e in runner)
        away = runner + [(s, e) for name, s, e in self.spans
                         if name == "bench.count"] + self.runtime
        gone = sum(e - s for s, e in clip(merge(away), lo, hi))
        return (hi - lo - gone) / (len(runner) - 1)

    def top_kernels(self, n=10):
        """[[name, seconds]] of the kernels that took the most time."""
        total = {}
        for name, s, e in self.kernels:
            total[name] = total.get(name, 0.0) + (e - s)
        ranked = sorted(total.items(), key=lambda kv: -kv[1])[:n]
        return [[name[:120], us * 1e-6] for name, us in ranked]

    def idle_gaps(self, n=10):
        """[[what the host was doing, seconds]] of the longest gaps in
        which no kernel ran: the innermost benchmark span open at the
        gap's start (``host`` where none was)."""
        busy = self.busy()
        edges = [self.start] + [x for iv in busy for x in iv] + [self.end]
        gaps = [(edges[k], edges[k + 1]) for k in range(0, len(edges), 2)
                if edges[k + 1] > edges[k]]
        out = []
        for start, end in sorted(gaps, key=lambda g: g[0] - g[1])[:n]:
            open_spans = [(s, name) for name, s, e in self.spans
                          if s <= start < e]
            label = max(open_spans)[1] if open_spans else "host"
            out.append([label, (end - start) * 1e-6])
        return out


def reduce_profile(prof, steps):
    """A ``DeviceTrace`` of a stopped ``torch.profiler.profile``."""
    from torch.autograd import DeviceType

    kernels, spans, runtime = [], [], []
    for e in prof.events():
        interval = (e.name, float(e.time_range.start),
                    float(e.time_range.end))
        if e.device_type == DeviceType.CUDA:
            if not getattr(e, "is_user_annotation", False):
                kernels.append(interval)
        elif e.name.startswith("bench."):
            spans.append(interval)
        elif RUNTIME.match(e.name):
            runtime.append(interval[1:])
    return DeviceTrace(kernels, spans, steps, runtime)


class StepClock:
    """Runner calls and their real rows; with ``stretch`` (first call,
    number of calls) the profiler over those calls."""

    def __init__(self, stretch=None, device=None):
        self.calls = 0
        self.overhead = 0.0  # host seconds of the profiler's start and stop
        self.stretch = stretch
        self.device = device
        self.profile = None
        self._prof = None
        self._rows = None
        self._hooks = {}
        self._epoch_t0 = None
        self.preambles = []  # each epoch's host seconds to its first step

    def after(self, call, fn):
        """Run ``fn()`` once the ``call``-th runner call (counted from 1)
        has returned."""
        self._hooks[call] = fn

    def count_rows(self, mask):
        """Add the real rows of a step's ``mask`` to the device's count."""
        with self.span("count"):
            if self._rows is None:
                self._rows = torch.zeros((), dtype=torch.float64,
                                         device=mask.device)
            self._rows.add_(mask.sum(dtype=torch.float64))

    def epoch_started(self):
        """Time the host takes from now to the next runner call."""
        self._epoch_t0 = time.perf_counter()

    def reset_rows(self):
        if self._rows is not None:
            self._rows.zero_()

    def rows(self):
        """The real rows counted since the last reset (reads the device)."""
        return 0 if self._rows is None else int(round(float(self._rows)))

    def _sync(self):
        if self.device is not None and self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def span(self, name):
        if self.stretch is None:
            return contextlib.nullcontext()
        return torch.profiler.record_function("bench." + name)

    def call(self, fn, kind, mask=None):
        """``fn()``, a runner call of ``kind`` over a step whose row mask
        is ``mask``."""
        if self._epoch_t0 is not None:
            self.preambles.append(time.perf_counter() - self._epoch_t0)
            self._epoch_t0 = None
        if self.stretch and self.calls == self.stretch[0]:
            from torch.profiler import ProfilerActivity, profile

            t0 = time.perf_counter()
            self._sync()
            activities = [ProfilerActivity.CPU]
            if self.device is not None and self.device.type == "cuda":
                activities.append(ProfilerActivity.CUDA)
            self._prof = profile(activities=activities)
            self._prof.start()
            self.overhead += time.perf_counter() - t0
        with self.span("runner." + kind):
            out = fn()
        self.calls += 1
        hook = self._hooks.pop(self.calls, None)
        if hook is not None:
            hook()
        if self._prof is not None and (
                self.calls == self.stretch[0] + self.stretch[1]):
            t0 = time.perf_counter()
            self._sync()
            self._prof.stop()
            self.profile, self._prof = self._prof, None
            self.overhead += time.perf_counter() - t0
        if mask is not None:
            # the mask as the step read it; a traced stretch holds the
            # counts of all its steps but its last
            self.count_rows(mask)
        return out

    def close(self):
        """Stop a stretch the window ended inside: it gives no trace."""
        if self._prof is not None:
            self._prof.stop()
            self._prof = None

    def device_trace(self):
        """The traced stretch as a ``DeviceTrace``, or None."""
        if self.profile is None:
            return None
        return reduce_profile(self.profile, self.stretch[1])


class RunnerProbe:
    """A ``StepRunner`` whose ``train`` and ``eval`` pass through a
    ``StepClock``; every other attribute is the runner's."""

    def __init__(self, runner, clock):
        self._runner = runner
        self._clock = clock

    def __getattr__(self, name):
        return getattr(self._runner, name)

    def train(self):
        return self._clock.call(self._runner.train, "train",
                                self._runner.inputs["mask"])

    def eval(self):
        return self._clock.call(self._runner.eval, "eval",
                                self._runner.inputs["mask"])


class BucketProbe:
    """A nested fold's ``BucketRunners`` whose runners are probed."""

    def __init__(self, runners, clock):
        self._runners = runners
        self._clock = clock

    def __getitem__(self, size):
        return RunnerProbe(self._runners[size], self._clock)
