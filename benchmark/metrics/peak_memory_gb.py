"""The allocator's peak over set-up and the window, in GB (1e9 bytes)."""


def read(run):
    peak = run.counters["memory_peak_bytes"]
    return peak / 1e9 if peak else None
