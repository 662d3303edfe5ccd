"""DTW scoring over breaths: padded pair batches and rolling scores.

Counterpart of the scoring half of ``deepards_tpu/dtw/lib.py``: every
scoring task is flattened into padded pair batches and dispatched to the
batched DTW of ``deepards_tpu_torch.ops.dtw`` on ``device`` (default: the
card, where the CUDA kernel runs).
"""
import numpy as np

from deepards_tpu_torch.device import resolve_device
from deepards_tpu_torch.ops.dtw import dtw_batch


def _pad_pairs(seqs_a, seqs_b, width_bucket=64, batch_bucket=True):
    """Ragged pair lists -> padded (B, n) arrays + length vectors.

    The width rounds up to a multiple of ``width_bucket`` and the batch
    to the next power of two (>=128), so a sweep sees few distinct shapes.
    Pad rows carry length 1 (a 1x1 DP, ignored); per-pair results do not
    depend on the padding because the DP masks by (la, lb)."""
    n = max(
        max((len(a) for a in seqs_a), default=1),
        max((len(b) for b in seqs_b), default=1),
    )
    n = -(-n // width_bucket) * width_bucket
    bsz = len(seqs_a)
    padded_bsz = bsz
    if batch_bucket:
        padded_bsz = 128
        while padded_bsz < bsz:
            padded_bsz *= 2

    def fill(seqs):
        dst = np.zeros((padded_bsz, n), np.float32)
        lens = np.ones(padded_bsz, np.int32)
        if bsz:
            ls = np.fromiter((len(s) for s in seqs), np.int64, count=bsz)
            lens[:bsz] = ls
            # vectorized ragged scatter: row r gets seqs[r][:ls[r]]
            rows = np.repeat(np.arange(bsz), ls)
            starts = np.cumsum(ls) - ls
            cols = np.arange(ls.sum()) - np.repeat(starts, ls)
            dst[rows, cols] = np.concatenate(
                [np.asarray(s, np.float32).ravel() for s in seqs]
            )
        return dst, lens

    a, la = fill(seqs_a)
    b, lb = fill(seqs_b)
    return a, b, la, lb


def batched_dtw_pairs(seqs_a, seqs_b, chunk=8192, device=None):
    """DTW distance for each (seqs_a[i], seqs_b[i]) pair; ragged input.

    Pairs run in length-sorted order, so one long outlier widens one
    chunk rather than every chunk, in chunks of up to ``chunk`` pairs
    padded by ``_pad_pairs``.  Results are scattered back to input order;
    each pair's DP is independent, so values do not depend on chunking or
    sorting.
    """
    device = resolve_device(device)
    m = len(seqs_a)
    out = np.zeros(m, np.float64)
    if m == 0:
        return out
    order = np.argsort(
        [max(len(a), len(b)) for a, b in zip(seqs_a, seqs_b)],
        kind="stable",
    )
    for start in range(0, m, chunk):
        idx = order[start : start + chunk]
        a, b, la, lb = _pad_pairs(
            [seqs_a[i] for i in idx], [seqs_b[i] for i in idx]
        )
        d = dtw_batch(a, b, la, lb, device=device)[: len(idx)]
        out[idx] = d.cpu().numpy().astype(np.float64)
    return out


def per_breath_dtw_scores(breaths, n_breaths=3, device=None):
    """Rolling DTW of each breath vs its previous ``n_breaths`` breaths:
    score_i = mean_k dtw(b_i, b_{i-k}).

    All (i, i-k) pairs flatten into one batch.  Returns (len(breaths),)
    with NaN for the first ``n_breaths`` entries.
    """
    device = resolve_device(device)
    n = len(breaths)
    scores = np.full(n, np.nan)
    if n <= n_breaths:
        return scores
    pairs_a, pairs_b = [], []
    for i in range(n_breaths, n):
        for k in range(1, n_breaths + 1):
            pairs_a.append(breaths[i])
            pairs_b.append(breaths[i - k])
    d = batched_dtw_pairs(pairs_a, pairs_b, device=device)
    scores[n_breaths:] = d.reshape(n - n_breaths, n_breaths).mean(axis=1)
    return scores


def dtw_analyze(pt_data, n_breaths, rolling_av_len, pt_preds_by_hour,
                device=None):
    """Per-breath rolling DTW over a patient's window sequence, aligned
    with prediction hours: a DataFrame with columns dtw and hour, indexed
    by observation."""
    import pandas as pd

    breaths = []
    df_idx = []
    hrs = []
    pt_obs_idxs = list(pd.unique(pt_preds_by_hour.index))
    for idx, seq in enumerate(pt_data):
        cur_obs_idx = pt_obs_idxs[idx] if idx < len(pt_obs_idxs) else idx
        hours = pt_preds_by_hour.loc[[cur_obs_idx]].hour.tolist()
        for j, breath in enumerate(np.asarray(seq)):
            breaths.append(np.asarray(breath).ravel())
            df_idx.append(cur_obs_idx)
            hrs.append(hours[j % len(hours)] if hours else np.nan)
    scores = per_breath_dtw_scores(breaths, n_breaths, device=device)
    hrs = np.asarray(hrs, np.float64)
    hrs[:n_breaths] = np.nan
    if rolling_av_len > 1:
        kern = np.ones(rolling_av_len) / rolling_av_len
        rolled = np.convolve(scores, kern, mode="valid")
        scores = np.append([np.nan] * (rolling_av_len - 1), rolled)
    return pd.DataFrame(
        {"dtw": scores, "hour": hrs}, index=df_idx
    )
