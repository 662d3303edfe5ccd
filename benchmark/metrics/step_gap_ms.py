"""The device time between one step's end and the next step's start, in
ms, a mean over the window's pairs of step events (the program's CUDA
events around each graph replay, recorded with no profiler running): the
staging kernels, copies, epoch starts and any idle, without the
profiler."""
from benchmark import program_spans


def read(run):
    gap = (program_spans.step_events() or {}).get("step.gap")
    if not gap:
        return None
    return gap["seconds"] * 1e3 / gap["count"]
