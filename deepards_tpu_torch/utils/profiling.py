"""Profiling and tracing utilities.

Counterpart of ``deepards_tpu/utils/profiling.py`` (the reference had no
built-in profiling, SURVEY.md §5.1): a step timer that reports
steady-state throughput, ``trace`` around any code for a Chrome trace of
``torch.profiler`` (host ops and, on the card, CUDA kernels), and
``annotate`` for a named span in it.

On the card ``StepTimer.tick()`` reads the host clock, so it times the
dispatch of a step unless the caller synchronizes
(``torch.cuda.synchronize()``) before each tick.

The program's own measurement, always on and kept in one table for the
process:

- ``annotate(name)`` is the program's span (``deepards.<layer>.<what>``).
  It enters a ``torch.profiler.record_function`` only while a profiler
  is recording, so the span shares the profiler's clock with the kernels
  and the CUDA runtime calls, and costs two clock reads and a dict
  update otherwise; either way it adds its host seconds and a count to
  the table.
- ``count(name, n)`` adds to a plain counter (``windows.real``,
  ``windows.pad``).
- ``step_events``: on the card ``StepRunner`` records a CUDA event on the
  current stream before and after each graph replay (none while a
  profiler records, none on the CPU) into a fixed ring, resolved only
  when the ring reuses a slot or ``totals()`` is asked, so the step path
  never waits.  They give the graph's device time a step
  (``step.device``) and the device time between one step's end and the
  next step's start (``step.gap``: the staging kernels, copies, epoch
  starts and any idle), at one ``elapsed_time`` a pair; a pair not done
  when its slot comes round is counted in ``step.events_dropped``.
- ``totals()`` returns a copy of all of it; ``reset_totals()`` zeroes it.

The table is updated from the thread that runs the steps.
"""
import contextlib
import os
import tempfile
import time

import torch

_clock = time.perf_counter
_recording = torch._C._autograd._profiler_enabled

_spans = {}  # name -> [host seconds, count]
_counters = {}  # name -> number


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


class annotate:
    """Named span: a ``record_function`` in the profiler's timeline while
    a profiler records, and always its host seconds and count in the
    process's totals."""

    __slots__ = ("name", "_record", "_t0")

    def __init__(self, name):
        self.name = name
        self._record = None

    def __enter__(self):
        if _recording():
            self._record = torch.profiler.record_function(self.name)
            self._record.__enter__()
        self._t0 = _clock()
        return self

    def __exit__(self, *exc):
        seconds = _clock() - self._t0
        if self._record is not None:
            self._record.__exit__(*exc)
            self._record = None
        entry = _spans.get(self.name)
        if entry is None:
            _spans[self.name] = [seconds, 1]
        else:
            entry[0] += seconds
            entry[1] += 1
        return False


def count(name, n=1):
    """Add ``n`` to the counter ``name``."""
    _counters[name] = _counters.get(name, 0) + n


class StepEvents:
    """Pairs of timing events around steps on the card, in a ring of
    ``size`` pairs.  A pair is resolved when its slot comes round again
    or in ``totals``; ``size`` lies far beyond the steps the host can
    queue ahead of the device, so the pair is done by then.  One that is
    not (the host that far ahead) is dropped and counted in
    ``step.events_dropped`` rather than waited for.  A step left out
    while a profiler records breaks the chain: the next pair has no gap
    before it.

    Resolving a pair reads one ``elapsed_time``, its gap from the last
    pair's end.  The steps' device time is a chain's (pairs resolved one
    after the other, each with its gap) whole time, from its first start
    to its last end, less its gaps: one more ``elapsed_time`` a chain.
    """

    def __init__(self, size=4096):
        self.size = size
        # [start event, end event, follows the last pair, stream]
        self.slots = []
        self.recorded = 0  # pairs recorded
        self.resolved = 0  # pairs resolved (or dropped)
        self._chained = False
        # the chain being resolved: its first start, its last end (both
        # taken out of the ring), its pairs and its gaps in ms
        self._first = self._last = None
        self._pairs, self._gaps = 0, 0.0
        self._spare = []  # events to put in the slots they are taken from
        self.sums = {"step.device": [0.0, 0], "step.gap": [0.0, 0]}

    def begin(self):
        """Record a step's start on the current stream; the pair to hand
        to ``end``, or None while a profiler records."""
        if _recording():
            self._chained = False
            return None
        k = self.recorded
        if k < self.size:
            self.slots.append([torch.cuda.Event(enable_timing=True),
                               torch.cuda.Event(enable_timing=True), False,
                               None])
        elif self.resolved <= k - self.size:
            self._resolve(k - self.size + 1, wait=False)
        pair = self.slots[k % self.size]
        # one lookup of the stream for both records: it costs more than one
        pair[3] = torch.cuda.current_stream()
        pair[2] = self._chained
        pair[0].record(pair[3])
        self._chained = True
        self.recorded = k + 1
        return pair

    @staticmethod
    def end(pair):
        if pair is not None:
            pair[1].record(pair[3])

    def _resolve(self, upto, wait):
        for j in range(self.resolved, upto):
            pair = self.slots[j % self.size]
            if wait:
                pair[1].synchronize()
            elif not pair[1].query():
                count("step.events_dropped")
                self._close()
                continue
            if pair[2] and self._last is not None:
                gap = self._last.elapsed_time(pair[0])
                self._add("step.gap", gap, 1)
                self._gaps += gap
                self._spare.append(self._last)
            else:
                self._close()
                self._first = self._take(pair, 0)
            self._last = self._take(pair, 1)
            self._pairs += 1
        self.resolved = max(self.resolved, upto)

    def _take(self, pair, k):
        """The pair's event ``k``, its slot given a spare in its place."""
        event = pair[k]
        pair[k] = (self._spare.pop() if self._spare
                   else torch.cuda.Event(enable_timing=True))
        return event

    def _chain_ms(self):
        """The device time of the chain's steps, in ms."""
        return self._first.elapsed_time(self._last) - self._gaps

    def _close(self):
        """Add the chain's steps to the sums and start none."""
        if self._pairs:
            self._add("step.device", self._chain_ms(), self._pairs)
        self._spare += [e for e in (self._first, self._last)
                        if e is not None]
        self._first = self._last = None
        self._pairs, self._gaps = 0, 0.0

    def _add(self, name, ms, n):
        entry = self.sums[name]
        entry[0] += ms * 1e-3
        entry[1] += n

    def totals(self):
        """The sums of every pair recorded, waiting for the last ones."""
        self._resolve(self.recorded, wait=True)
        out = {k: [s, n] for k, (s, n) in self.sums.items()}
        if self._pairs:
            out["step.device"][0] += self._chain_ms() * 1e-3
            out["step.device"][1] += self._pairs
        return {k: {"seconds": s, "count": n}
                for k, (s, n) in out.items() if n}

    def reset(self):
        self.resolved = self.recorded
        self._chained = False
        self._pairs = 0
        self._close()
        for entry in self.sums.values():
            entry[0], entry[1] = 0.0, 0


step_events = StepEvents()


def totals():
    """A copy of the process's totals: ``spans`` {name: {"seconds",
    "count"}}, ``counters`` {name: number} and ``device`` {"step.device",
    "step.gap": {"seconds", "count"}} (empty with no event resolved)."""
    return {"spans": {k: {"seconds": s, "count": n}
                      for k, (s, n) in _spans.items()},
            "counters": dict(_counters),
            "device": step_events.totals()}


def reset_totals():
    """Zero the totals; pairs of events not yet resolved are left out."""
    _spans.clear()
    _counters.clear()
    step_events.reset()
