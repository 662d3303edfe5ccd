"""The deferred records' host time an epoch: the flush of the trainer's
queue at the window's end (losses and outputs fetched, votes, AUC, the
predictions by hour), over the epochs it records."""


def read(run):
    c = run.counters
    if not c["epochs"]:
        return None
    return c["flush_s"] * 1e3 / c["epochs"]
