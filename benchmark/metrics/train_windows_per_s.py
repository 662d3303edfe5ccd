"""Real windows trained a second: every window of the window's train epochs
(pad rows left out) over the window's whole time, its deferred records
included."""


def read(run):
    c = run.counters
    if c["epoch_kind"] != "train":
        return None
    return c["windows"] / c["window_s"]
