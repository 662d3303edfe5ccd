"""What the program measures of itself, as the per-layer metrics read it.

- The program's spans (``deepards.<layer>.<what>``, from
  ``deepards_tpu_torch.utils.profiling.annotate``) in the traced
  stretch's profile, on the clock of its kernels: the device's idle time
  in which the host was inside one span or another.  The idle intervals
  are the stretch less the union of its kernels (``DeviceTrace.busy``).
- The process's totals (``profiling.totals()``): spans' host seconds,
  counters and the step events' device times.  One run is one process
  and its set-up takes no trainer step, so they are the window's.

A program without them (the span absent from the trace, no ``totals``)
reads as None.
"""
import sys

from benchmark.trace import merge


def idle(trace):
    """The stretch's idle intervals, sorted and disjoint."""
    out, at = [], trace.start
    for start, end in trace.busy():
        if start > at:
            out.append((at, start))
        at = max(at, end)
    if trace.end > at:
        out.append((at, trace.end))
    return out


def overlap(a, b):
    """The length of the intersection of two sorted disjoint interval
    lists."""
    total, i, j = 0.0, 0, 0
    while i < len(a) and j < len(b):
        lo, hi = max(a[i][0], b[j][0]), min(a[i][1], b[j][1])
        if hi > lo:
            total += hi - lo
        if a[i][1] < b[j][1]:
            i += 1
        else:
            j += 1
    return total


def host_spans(profile, name):
    """[(start, end)] of the host's spans ``name`` in a stopped profile."""
    from torch.autograd import DeviceType

    return [(float(e.time_range.start), float(e.time_range.end))
            for e in profile.events()
            if e.name == name and e.device_type == DeviceType.CPU]


def idle_ms_per_step(run, name):
    """The traced stretch's idle time in which the host was inside span
    ``name``, in ms a step; None without a trace of the device or without
    such a span."""
    trace, profile = run.trace, run.clock.profile
    if trace is None or profile is None or not trace.kernels:
        return None
    spans = host_spans(profile, name)
    if not spans:
        return None
    return overlap(idle(trace), merge(spans)) * 1e-3 / trace.steps


def totals():
    """The program's totals, or None for a program without them."""
    from deepards_tpu_torch.utils import profiling

    read = getattr(profiling, "totals", None)
    return read() if read is not None else None


def step_events():
    """The step events' sums, {"step.device", "step.gap": {"seconds",
    "count"}}, or None for a program without them or with none resolved.
    Pairs the ring dropped (``step.events_dropped``) are missing from the
    sums; the run says so on standard error."""
    got = totals()
    if not got or not got.get("device"):
        return None
    dropped = got.get("counters", {}).get("step.events_dropped", 0)
    if dropped:
        print("step events: {} pairs dropped, left out of the sums".format(
            dropped), file=sys.stderr)
    return got["device"]
