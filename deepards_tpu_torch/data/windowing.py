"""Window assembly: turn per-patient breath streams into fixed-shape
breath-window arrays.

A copy of ``deepards_tpu/data/windowing.py``: pure numpy/scipy, kept in the port
so that it imports nothing of the JAX package.

Implements all 13 dataset types of the reference ETL
(reference: deepards/dataset.py:506-533 dispatch; processing funcs
:1233-1293) as a single streaming assembler that emits dense numpy arrays
(the ``WindowCache``) instead of a Python list of per-window objects.  The
carry-over/window-boundary semantics of each type are preserved exactly;
this runs once per cohort on the host (cold path) — the device only ever
sees dense arrays.
"""
import itertools
from dataclasses import dataclass, field
from typing import Optional

import numpy as np

_CACHE_TOKENS = itertools.count()
from scipy.signal import resample

from deepards_tpu_torch.data.breath import find_x0_index, flow_time_features

SEQ_LEN = 224

# dataset types grouped by processing family
BREATH_BY_BREATH_TYPES = {
    "padded_breath_by_breath": "pad",
    "stretched_breath_by_breath": "stretch",
    "spaced_padded_breath_by_breath": "spaced_pad",
}
UNPADDED_TYPES = {
    "unpadded_sequences": ("regular", False),
    "unpadded_centered_sequences": ("centered", False),
    "unpadded_downsampled_sequences": ("regular", True),
    "unpadded_centered_downsampled_sequences": ("centered", True),
    "unpadded_downsampled_autoencoder_sequences": ("regular", True),
}
BM_TARGET_TYPES = {
    "padded_breath_by_breath_with_limited_bm_target": [
        "iTime", "eTime", "inst_RR",
    ],
    "padded_breath_by_breath_with_experimental_bm_target": [
        "iTime", "eTime", "inst_RR", "mean_flow_from_pef", "I:E ratio",
        "tve:tvi ratio", "dyn_compliance",
    ],
    "padded_breath_by_breath_with_full_bm_target": [
        "mean_flow_from_pef", "inst_RR", "slope_minF_to_zero",
        "pef_+0.16_to_zero", "iTime", "eTime", "I:E ratio",
        "dyn_compliance", "tve:tvi ratio",
    ],
}
ALL_DATASET_TYPES = (
    list(BREATH_BY_BREATH_TYPES)
    + list(UNPADDED_TYPES)
    + list(BM_TARGET_TYPES)
    + [
        "padded_breath_by_breath_with_flow_time_features",
        "unpadded_centered_with_bm",
    ]
)

# z-scoring constants for flow-time metadata features
# (reference: deepards/dataset.py:473-482)
FLOW_TIME_BM_MU = np.array([
    -1.12003803e+01, 2.27065158e+01, 5.41515510e+01, 2.68864330e+01,
    8.81662707e-01, 1.98707801e+00, 5.14447986e-01, 3.08663952e-02,
    1.03526574e+00,
])
FLOW_TIME_BM_STD = np.array([
    4.96512973e+00, 6.28153415e+00, 9.68798546e+01, 2.14905835e+01,
    1.57385909e-01, 8.65758973e-01, 4.93673691e-01, 5.38365875e-02,
    5.44132642e-01,
])


@dataclass
class WindowCache:
    """Dense array-of-struct cache of assembled breath windows.

    data: (N, S, C, L) float32 — S sub-batches of C-channel length-L rows
    target: (N, T) float32 — one-hot patho (T=2) or regression targets
    hours: (N, S) float32 — hour-into-study per sub-sequence (nan padded)
    patient_idx: (N,) int32 index into ``patients``
    meta: optional per-window metadata (flow-time features)
    """

    data: np.ndarray
    target: np.ndarray
    hours: np.ndarray
    patient_idx: np.ndarray
    patients: list
    meta: Optional[np.ndarray] = None
    frames_dropped: dict = field(default_factory=dict)
    # monotonic identity for device-side copies: id() values recycle after
    # GC, so trainers key their HBM-resident uploads on this token instead
    token: int = field(default_factory=lambda: next(_CACHE_TOKENS))

    def bump_token(self):
        """Invalidate device-side copies after in-place array mutation."""
        self.token = next(_CACHE_TOKENS)

    def __len__(self):
        return self.data.shape[0]

    @property
    def n_sub_batches(self):
        return self.data.shape[1]

    def patient_of(self, idx):
        return self.patients[self.patient_idx[idx]]


def pad_breath(flow, seq_len=SEQ_LEN):
    """Zero-pad (or truncate) a breath to seq_len
    (reference: deepards/dataset.py:1233-1237)."""
    if len(flow) >= seq_len:
        return np.asarray(flow[:seq_len], dtype=np.float32)
    out = np.zeros(seq_len, dtype=np.float32)
    out[: len(flow)] = flow
    return out


def stretch_breath(flow, seq_len=SEQ_LEN):
    """FFT-resample a short breath up to seq_len
    (reference: deepards/dataset.py:1239-1243)."""
    if len(flow) < seq_len:
        return resample(flow, seq_len).astype(np.float32)
    return np.asarray(flow[:seq_len], dtype=np.float32)


def spaced_pad_breath(flow, seq_len=SEQ_LEN):
    """Distribute samples evenly over seq_len with zero gaps
    (reference: deepards/dataset.py:1245-1258)."""
    n = len(flow)
    if n >= seq_len:
        return np.asarray(flow[:seq_len], dtype=np.float32)
    spacing = n / float(seq_len)
    out = np.zeros(seq_len, dtype=np.float32)
    i = 0
    for j in range(seq_len):
        if j * spacing >= i:
            out[j] = flow[i]
            i += 1
        elif j * spacing > n - 1:
            break
    return out


_PROCESS_FUNCS = {
    "pad": pad_breath,
    "stretch": stretch_breath,
    "spaced_pad": spaced_pad_breath,
}


def should_drop_frame(seq_vent_bns, n_sub_batches, vent_bn_frac_missing=0.5):
    """Drop a window whose ventilator breath numbers are too discontiguous,
    with 2^16 wraparound forgiveness
    (reference: deepards/dataset.py:1308-1321)."""
    v = np.asarray(seq_vent_bns, dtype=np.int64)
    if len(v) < 2:
        return False
    diffs = v[:-1] + 1 - v[1:]
    bns_missing = int(np.abs(diffs).sum())
    missing_thresh = int(n_sub_batches * vent_bn_frac_missing)
    if bns_missing > missing_thresh:
        if not abs(bns_missing - (2 ** 16)) <= missing_thresh:
            return True
    return False


def truncate_lim(flow, drop_i_lim=False, drop_e_lim=False, truncate_e_lim=None):
    """Optionally drop/truncate the inspiratory or expiratory limb using x0
    detection (reference: deepards/dataset.py:1183-1204)."""
    if not (drop_i_lim or drop_e_lim or truncate_e_lim):
        return flow
    dt = 0.02
    x0 = find_x0_index(flow)
    start, end = 0, len(flow)
    if truncate_e_lim is not None:
        end = x0 + int(np.ceil(truncate_e_lim / dt))
    if drop_i_lim:
        start = x0
    elif drop_e_lim:
        end = x0
    return flow[start:end]


class _Accum:
    """Per-patient accumulation state plus output row collection."""

    def __init__(self):
        self.rows = []       # list of (patient_id, data(S,C,L), meta|None, target, hours)
        self.reset()

    def reset(self):
        self.batch_arr = []
        self.breath_arr = []
        self.vent_bns = []
        self.hours = []
        self.meta_arr = []


def _emit(acc, patient_id, target, n_sub_batches, meta=None,
          frames_dropped=None, vent_bn_frac_missing=0.5):
    """Emit the accumulated window if its vent_bns are contiguous enough."""
    if should_drop_frame(acc.vent_bns, n_sub_batches, vent_bn_frac_missing):
        if frames_dropped is not None:
            frames_dropped[patient_id] = frames_dropped.get(patient_id, 0) + 1
        dropped = True
    else:
        data = np.asarray(acc.batch_arr, dtype=np.float32).reshape(
            n_sub_batches, 1, SEQ_LEN
        )
        acc.rows.append(
            (patient_id, data, meta, np.asarray(target, np.float32),
             list(acc.hours))
        )
        dropped = False
    acc.batch_arr = []
    acc.vent_bns = []
    acc.hours = []
    acc.meta_arr = []
    if dropped:
        # reference drops the partial carry-over breath too, "to be safe"
        # (deepards/dataset.py:1064-1070)
        acc.breath_arr = []
    return dropped


def assemble_windows(
    breath_stream,
    dataset_type,
    n_sub_batches,
    unpadded_downsample_factor=4.0,
    drop_i_lim=False,
    drop_e_lim=False,
    truncate_e_lim=None,
    vent_bn_frac_missing=0.5,
    drop_if_under_r2=0.0,
    autocorr_r2=None,
):
    """Assemble breath windows for one run of (patient_id, breath, seq_hour)
    tuples, already filtered to the 24h study window and >=21 samples.

    ``breath_stream`` yields (patient_id, breath_dict, seq_hour).  Returns
    the raw row list; use ``rows_to_cache`` to densify.
    """
    if dataset_type in BREATH_BY_BREATH_TYPES:
        proc = _PROCESS_FUNCS[BREATH_BY_BREATH_TYPES[dataset_type]]
        mode = "breath_by_breath"
        bm_features = None
    elif dataset_type in UNPADDED_TYPES:
        mode, downsample = UNPADDED_TYPES[dataset_type]
        bm_features = None
    elif dataset_type in BM_TARGET_TYPES:
        proc = pad_breath
        mode = "bm_target"
        bm_features = BM_TARGET_TYPES[dataset_type]
    elif dataset_type == "padded_breath_by_breath_with_flow_time_features":
        proc = pad_breath
        mode = "flow_time_features"
        bm_features = None
    elif dataset_type == "unpadded_centered_with_bm":
        mode = "centered_with_bm"
        downsample = False
        bm_features = None
    else:
        raise ValueError("Unknown dataset type: {}".format(dataset_type))

    acc = _Accum()
    frames_dropped = {}
    last_patient = None

    for patient_id, breath, seq_hour in breath_stream:
        if patient_id != last_patient:
            acc.reset()
        last_patient = patient_id

        flow = np.asarray(breath["flow"], dtype=np.float64)
        flow = truncate_lim(flow, drop_i_lim, drop_e_lim, truncate_e_lim)
        target = breath["_target"]

        if mode == "breath_by_breath":
            acc.batch_arr.append(proc(flow))
            acc.vent_bns.append(breath["vent_bn"])
            acc.hours.append(seq_hour)
            if len(acc.batch_arr) == n_sub_batches:
                _emit(acc, patient_id, target, n_sub_batches,
                      frames_dropped=frames_dropped,
                      vent_bn_frac_missing=vent_bn_frac_missing)

        elif mode == "bm_target":
            feats = flow_time_features(flow, breath.get("pressure"))
            names_all = [
                "mean_flow_from_pef", "inst_RR", "slope_minF_to_zero",
                "pef_+0.16_to_zero", "iTime", "eTime", "I:E ratio",
                "dyn_compliance", "tve:tvi ratio",
            ]
            sel = np.array(
                [feats[names_all.index(f)] for f in bm_features]
            )
            if np.any(np.isnan(sel) | np.isinf(sel)):
                continue
            ratio_sel = [
                i for i, f in enumerate(bm_features)
                if f in ("I:E ratio", "tve:tvi ratio")
            ]
            # ratio clip guard against gradient blow-ups
            # (reference: deepards/dataset.py:952-956)
            if ratio_sel and np.any(np.abs(sel[ratio_sel]) > 100):
                continue
            acc.rows.append((
                patient_id,
                proc(flow).reshape(1, 1, SEQ_LEN),
                None,
                sel.astype(np.float32),
                [np.nan],
            ))

        elif mode == "flow_time_features":
            feats = flow_time_features(flow, breath.get("pressure"))
            if np.any(np.isnan(feats) | np.isinf(feats)):
                continue
            if np.any(np.abs(feats[[6, 8]]) > 100):
                continue
            feats = (feats - FLOW_TIME_BM_MU) / FLOW_TIME_BM_STD
            acc.batch_arr.append(proc(flow))
            acc.vent_bns.append(breath["vent_bn"])
            acc.hours.append(seq_hour)
            acc.meta_arr.append(feats.astype(np.float32))
            if len(acc.batch_arr) == n_sub_batches:
                meta = np.asarray(acc.meta_arr, dtype=np.float32)
                _emit(acc, patient_id, target, n_sub_batches, meta=meta,
                      frames_dropped=frames_dropped,
                      vent_bn_frac_missing=vent_bn_frac_missing)

        elif mode in ("regular", "centered", "centered_with_bm"):
            if mode != "centered_with_bm" and downsample:
                new_samples = int(
                    np.ceil(len(flow) / float(unpadded_downsample_factor))
                )
                flow = resample(flow, new_samples)
            acc.vent_bns.append(breath["vent_bn"])
            if mode == "centered_with_bm":
                feats = flow_time_features(flow, breath.get("pressure"))
                acc.meta_arr.append(feats)
            # accumulate concatenated flow into 224-sample sub-sequences
            if (len(flow) + len(acc.breath_arr)) < SEQ_LEN:
                acc.breath_arr.extend(flow)
            else:
                remaining = SEQ_LEN - len(acc.breath_arr)
                acc.breath_arr.extend(flow[:remaining])
                acc.batch_arr.append(
                    np.asarray(acc.breath_arr, dtype=np.float32)
                )
                acc.hours.append(seq_hour)
                if mode == "centered" or mode == "centered_with_bm":
                    # centered: next sub-sequence starts at a breath start
                    # (reference: deepards/dataset.py:1279-1288)
                    acc.breath_arr = []
                else:
                    # regular: leftover flow carries over, capped at 224
                    # (reference: deepards/dataset.py:1260-1272)
                    left = list(flow[remaining:])
                    acc.breath_arr = left[:SEQ_LEN]
            if len(acc.batch_arr) == n_sub_batches:
                if mode == "centered_with_bm":
                    m = np.asarray(acc.meta_arr, dtype=np.float64)
                    m = m[~np.any(np.isnan(m) | np.isinf(m), axis=1)]
                    if len(m):
                        meta = np.stack([
                            m.mean(axis=0), np.median(m, axis=0)
                        ]).astype(np.float32)
                    else:
                        meta = np.zeros((2, 9), dtype=np.float32)
                else:
                    meta = None
                if drop_if_under_r2 and autocorr_r2 is not None:
                    seq = np.asarray(acc.batch_arr, np.float64).ravel()
                    if autocorr_r2(seq) < drop_if_under_r2:
                        acc.reset()
                        continue
                _emit(acc, patient_id, target, n_sub_batches, meta=meta,
                      frames_dropped=frames_dropped,
                      vent_bn_frac_missing=vent_bn_frac_missing)

    return acc.rows, frames_dropped


def rows_to_cache(rows, frames_dropped=None, autoencoder_target=False):
    """Densify assembled rows into a WindowCache."""
    if not rows:
        raise ValueError("no windows were assembled from the input data")
    patients = sorted({r[0] for r in rows})
    pt_map = {p: i for i, p in enumerate(patients)}
    n = len(rows)
    s, c, l = rows[0][1].shape
    data = np.zeros((n, s, c, l), dtype=np.float32)
    tdim = len(np.atleast_1d(rows[0][3]))
    target = np.zeros((n, tdim), dtype=np.float32)
    hours = np.full((n, s), np.nan, dtype=np.float32)
    patient_idx = np.zeros(n, dtype=np.int32)
    metas = []
    for i, (pt, d, meta, tgt, hrs) in enumerate(rows):
        data[i] = d
        target[i] = np.atleast_1d(tgt)
        hrs = np.asarray(hrs, dtype=np.float32)[:s]
        hours[i, : len(hrs)] = hrs
        patient_idx[i] = pt_map[pt]
        metas.append(meta)
    meta = None
    if metas[0] is not None:
        meta = np.stack(metas).astype(np.float32)
    if autoencoder_target:
        # autoencoder target is the input itself; keep patho target shape
        # as nan marker (reference: deepards/dataset.py:1206-1207)
        target = np.full((n, 2), np.nan, dtype=np.float32)
    return WindowCache(
        data=data,
        target=target,
        hours=hours,
        patient_idx=patient_idx,
        patients=patients,
        meta=meta,
        frames_dropped=frames_dropped or {},
    )


def perform_fft(cache, add_fft=False, only_fft=False, fft_real_only=False):
    """Append/replace FFT channels on the channel axis
    (reference: deepards/dataset.py:1330-1341)."""
    if not add_fft and not only_fft:
        return cache
    # the reference's fftshift has no axes argument (dataset.py:1334), so
    # per (S, C, L) sequence it also rolls the WINDOW axis by S//2 — the
    # fft channels of window k sit next to raw window (k+S//2)%S.
    # Reproduced exactly (axes 1..3 of our (N, S, C, L) cache).
    trans = np.fft.fftshift(np.fft.fft(cache.data, axis=-1),
                            axes=(1, 2, 3))
    chans = [trans.real] if fft_real_only else [trans.real, trans.imag]
    chans = [c.astype(np.float32) for c in chans]
    if add_fft:
        cache.data = np.concatenate([cache.data] + chans, axis=2)
    else:
        cache.data = np.concatenate(chans, axis=2)
    cache.bump_token()
    return cache
