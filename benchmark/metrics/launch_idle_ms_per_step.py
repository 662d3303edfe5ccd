"""The traced stretch's device idle time in which the host was inside a
step's call (the program's ``deepards.step.run`` spans: the graph's
replay, or the eager step), in ms a step."""
from benchmark import program_spans


def read(run):
    return program_spans.idle_ms_per_step(run, "deepards.step.run")
