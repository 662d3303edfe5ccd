"""The share of a step's device time spent before it, between steps, in
percent, without the profiler: the program's step events' mean
``step.gap`` (from one step's end to the next step's start) over that
mean plus the mean ``step.device`` (from a step's start to its end: the
graph's replay, any idle inside it included)."""
from benchmark import program_spans


def read(run):
    events = program_spans.step_events() or {}
    gap, device = events.get("step.gap"), events.get("step.device")
    if not gap or not device:
        return None
    gap = gap["seconds"] / gap["count"]
    return 100.0 * gap / (gap + device["seconds"] / device["count"])
