"""The share of the traced stretch in which no kernel ran, in percent:
100 less the union of the kernels' intervals over the stretch."""


def read(run):
    t = run.trace
    if t is None or not t.kernels:
        return None
    return 100.0 * t.idle_share()
