"""Kernels the device ran a step over the traced stretch."""


def read(run):
    t = run.trace
    if t is None or not t.kernels:
        return None
    return len(t.kernels) / t.steps
