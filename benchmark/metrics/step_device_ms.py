"""Device busy time a step over the traced stretch: the union of the
kernels' intervals, over the stretch's steps."""


def read(run):
    t = run.trace
    if t is None or not t.kernels:
        return None
    return t.busy_us * 1e-3 / t.steps
