"""Breath-science primitives: inspiration→expiration crossover (x0)
detection and per-breath flow-time features.

A copy of ``deepards_tpu/data/breath.py``: pure numpy/scipy, kept in the port
so that it imports nothing of the JAX package.

This is a from-scratch numpy implementation of the subset of the reference's
``ventmap``/``ucdpvanalysis`` dependency actually consumed by the pipeline
(reference: deepards/dataset.py:494-504 lists the 9 flow-time features;
truncate_lim at deepards/dataset.py:1183-1204 uses the x0 heuristic).  The
algorithms are semantics-exact rebuilds of the vendored SAM code
(ucdpvanalysis-1.5/algorithms/SAM.py: findx0:463, findx02:526, calcTV3:581,
find_mean_flow_from_pef:417, find_slope_from_minf_to_zero:428,
x0_heuristic:690), vectorized — including the legacy quirks that change
dataset contents: the 4-clause crossing test with the "dribble" clause,
truncating ``int(t_offset/dt)`` sample offsets (0.16s → 7 samples, not 8),
and findx02's never-flushed final run.  Pinned by differential oracle
tests against the vendored implementation (tests/test_breath_oracle.py).
"""
import numpy as np
from scipy.integrate import simpson

_trapezoid = getattr(np, "trapezoid", np.trapz)

DT = 0.02  # ventilator sampling period, 50 Hz
FS = 50.0

# The 9 flow-time features used as metadata / regression targets
# (order matters; reference: deepards/dataset.py:494-504).
FLOW_TIME_FEATURE_NAMES = [
    "mean_flow_from_pef",
    "inst_RR",
    "slope_minF_to_zero",
    "pef_+0.16_to_zero",
    "iTime",
    "eTime",
    "I:E ratio",
    "dyn_compliance",
    "tve:tvi ratio",
]


def _first_neg_crossing(flow):
    """First index where flow goes from >=0 to a sustained negative value.

    Exact vectorization of SAM ``findx0`` (SAM.py:463-525): crossing at
    i+1 when flow[i] >= 0 and any of
      1. flow[i+1] <= -5 and flow[i+2] < 0
      2. flow[i+1] < 0 and flow[i+4] <= -5
      3. flow[i+1] < 0 and flow[i+2] <= -5
      4. flow[i+1..i+5] all < 0          (low-flow "dribble" exhalation)
    (the legacy code pads 6 NaNs; NaN comparisons are False, matching).
    Returns len(flow)-1 when no crossing exists (SAM
    find_x0s_multi_algorithms:658 falls back to the last sample).
    """
    flow = np.asarray(flow, dtype=np.float64)
    n = len(flow)
    if n < 2:
        return n - 1 if n else 0
    w = np.concatenate([flow, np.full(6, np.nan)])
    i = np.arange(n)
    w1, w2, w3, w4, w5 = w[i + 1], w[i + 2], w[i + 3], w[i + 4], w[i + 5]
    cond = (w[i] >= 0) & (
        ((w1 <= -5) & (w2 < 0))
        | ((w1 < 0) & (w4 <= -5))
        | ((w1 < 0) & (w2 <= -5))
        | ((w1 < 0) & (w2 < 0) & (w3 < 0) & (w4 < 0) & (w5 < 0))
    )
    idx = np.nonzero(cond)[0]
    if len(idx):
        return int(idx[0]) + 1
    return n - 1


def _pos_neg_runs(flow):
    """Sign runs of flow[:-1] with >0 as positive (0 counts negative),
    EXCLUDING the final run, which the legacy loop never flushes
    (SAM findx02:526-578 / calcTV3:581-610 flush only on sign change).
    Yields (start, end_exclusive, is_pos); end_exclusive == legacy flush
    index i + 1."""
    flow = np.asarray(flow, dtype=np.float64)
    n = len(flow)
    if n < 2:
        return []
    w = flow[: n - 1]
    pos = w > 0
    # flush points: i in [0, n-2) where sign(w[i]) != sign(flow[i+1])
    nxt = flow[1:n] > 0
    flush = np.nonzero(pos != nxt)[0]
    runs = []
    start = 0
    for i in flush:
        runs.append((start, int(i) + 1, bool(pos[i])))
        start = int(i) + 1
    return runs


def _largest_pos_auc_end(flow):
    """Index one past the positive portion with the largest Simpson AUC
    (exact SAM ``findx02`` semantics: strict > keeps the first maximum;
    a positive run reaching the end of the wave is never considered).
    Returns len(flow)-1 when there is no flushed positive run."""
    flow = np.asarray(flow, dtype=np.float64)
    n = len(flow)
    if n < 2:
        return n - 1 if n else 0
    best_auc = 0.0
    x0 = None
    for s, e, is_pos in _pos_neg_runs(flow):
        if not is_pos:
            continue
        auc = float(simpson(flow[s:e], dx=DT)) * 1000.0 / 60.0
        if auc > best_auc:
            best_auc = auc
            x0 = e
    return int(x0) if x0 is not None else n - 1


def find_x0_index(flow):
    """Locate the inspiration→expiration crossover sample of a breath.

    Combines the two SAM detectors with the "use the later one" heuristic
    (SAM x0_heuristic:690-709 — important for nubbin breaths)."""
    x01 = _first_neg_crossing(flow)
    x02 = _largest_pos_auc_end(flow)
    return max(x01, x02)


def calc_tv(flow, x0_index, dt=DT, mode="run"):
    """(tvi, tve) in ml via Simpson AUC over sign runs: positive runs
    flushed before x0 count toward tvi, negative runs flushed at/after x0
    toward tve (tve returned NEGATIVE; callers flip sign).

    mode="run" (default) integrates each sign run — the corrected
    semantics the reference pipeline consumed via ventMAP.  mode=
    "legacy_prefix" is bit-exact with the vendored ucdpvanalysis
    ``calcTV3`` (SAM.py:581-610), whose holding array is never reset, so
    every flush integrates the ENTIRE wave prefix — kept only as the
    differential-test oracle target (tests/test_breath_oracle.py)."""
    flow = np.asarray(flow, dtype=np.float64)
    tvi = 0.0
    tve = 0.0
    for s, e, is_pos in _pos_neg_runs(flow):
        i = e - 1  # legacy flush index
        lo = 0 if mode == "legacy_prefix" else s
        auc = float(simpson(flow[lo:e], dx=dt)) * 1000.0 / 60.0
        if is_pos and i < x0_index:
            tvi += auc
        elif (not is_pos) and i >= x0_index:
            tve += auc
    return tvi, tve


def _slope_minf_to_zero(flow, dt=DT, t_offset=0.0):
    """Slope (l/min/s) from (min flow + offset) back up toward zero flow.

    Exact SAM ``find_slope_from_minf_to_zero`` semantics, including the
    truncating int(t_offset/dt) offset (0.16s -> 7 samples) and the
    first-occurrence max of the negative tail.  NaN when undefined."""
    flow = np.asarray(flow, dtype=np.float64)
    if len(flow) == 0:
        return np.nan
    min_idx = int(np.argmin(flow)) + int(t_offset / dt)
    if min_idx >= len(flow):
        return np.nan
    seg = flow[min_idx:]
    neg = seg < 0
    if not neg.any():
        return np.nan
    rel_zero_idx = int(np.argmax(np.where(neg, seg, -np.inf)))
    if rel_zero_idx == 0:
        return np.nan
    slope = (seg[rel_zero_idx] - seg[0]) / (rel_zero_idx * dt)
    return slope if slope >= 0 else np.nan


def _mean_flow_from_pef(flow, dt=DT, t_offset=0.16):
    """Mean flow from (peak expiratory flow + offset) to end of breath
    (exact SAM ``find_mean_flow_from_pef``, truncating offset)."""
    flow = np.asarray(flow, dtype=np.float64)
    if len(flow) == 0:
        return np.nan
    idx = int(np.argmin(flow)) + int(t_offset / dt)
    seg = flow[idx:]
    if len(seg) == 0:
        return np.nan
    return float(seg.mean())


def flow_time_features(flow, pressure=None, dt=DT):
    """Compute the 9 flow-time features for a single breath.

    ``flow`` in l/min.  ``pressure`` (cm H2O) is used for dynamic
    compliance; when absent dyn_compliance is NaN.  Returns a (9,) float64
    array ordered as FLOW_TIME_FEATURE_NAMES.
    """
    flow = np.asarray(flow, dtype=np.float64)
    n = len(flow)
    if n == 0:
        return np.full(9, np.nan)
    x0 = find_x0_index(flow)
    x0 = min(max(x0, 1), n)
    i_time = x0 * dt
    e_time = max((n - x0) * dt, dt)
    ie_ratio = i_time / e_time
    inst_rr = 60.0 / (i_time + e_time)
    tvi, tve = calc_tv(flow, x0, dt)
    tve = -tve  # legacy returns the (negative) expiratory AUC
    tve_tvi = tve / tvi if tvi > 0 else np.nan

    if pressure is not None and len(pressure):
        pressure = np.asarray(pressure, dtype=np.float64)
        pip = float(pressure.max())
        peep = float(pressure[-min(5, len(pressure)):].mean())
        denom = pip - peep
        dyn_c = (tvi / 1000.0) / denom if denom > 0 else np.nan
    else:
        dyn_c = np.nan

    return np.array([
        _mean_flow_from_pef(flow, dt),
        inst_rr,
        _slope_minf_to_zero(flow, dt),
        _slope_minf_to_zero(flow, dt, t_offset=0.16),
        i_time,
        e_time,
        ie_ratio,
        dyn_c,
        tve_tvi,
    ])
