"""Real windows scored a second: every window of the window's test epochs
(pad rows left out) over the window's whole time, the deferred records
(outputs, votes, AUC) included."""


def read(run):
    c = run.counters
    if c["epoch_kind"] != "test":
        return None
    return c["windows"] / c["window_s"]
