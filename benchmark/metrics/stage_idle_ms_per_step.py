"""The traced stretch's device idle time in which the host was filling a
step's inputs (the program's ``deepards.trainer.stage`` spans), in ms a
step."""
from benchmark import program_spans


def read(run):
    return program_spans.idle_ms_per_step(run, "deepards.trainer.stage")
