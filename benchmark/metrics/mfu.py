"""The whole step's share of the card's peak, in percent: the model FLOPs
of the window's real windows (counted once on the plain reference,
forward and backward for training, forward for a test epoch) over the
window's time, against the dense bfloat16 peak of the card in
``peaks.json``.  Nothing for a card the table lacks."""


def read(run):
    c = run.counters
    peak = (run.peak or {}).get("bf16_flops")
    if not peak or "flops_per_window" not in c:
        return None
    return 100.0 * c["windows"] * c["flops_per_window"] / c["window_s"] / peak
