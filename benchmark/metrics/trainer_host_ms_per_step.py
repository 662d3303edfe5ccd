"""The trainer's host time a step, from the traced stretch: the host's
time between consecutive runner calls, less its calls into the CUDA
runtime (where it waits whenever the device is behind) and the
benchmark's own row count."""


def read(run):
    if run.trace is None:
        return None
    us = run.trace.trainer_host_us()
    return None if us is None else us * 1e-3
