"""The share of the windows the steps ran that were padding, in percent:
the program's counters ``windows.pad`` over ``windows.real`` plus
``windows.pad`` (a nested step pads a patient to its bucket)."""
from benchmark import program_spans


def read(run):
    counters = (program_spans.totals() or {}).get("counters", {})
    real = counters.get("windows.real", 0)
    pad = counters.get("windows.pad", 0)
    if not real + pad:
        return None
    return 100.0 * pad / (real + pad)
