"""The deferred records' host time an epoch from the program's own span
(``deepards.records.flush``: losses and outputs fetched, meters, votes,
AUC, predictions by hour), over the epochs it records."""
from benchmark import program_spans


def read(run):
    span = (program_spans.totals() or {}).get("spans", {}).get(
        "deepards.records.flush")
    epochs = run.counters["epochs"]
    if not span or not epochs:
        return None
    return span["seconds"] * 1e3 / epochs
