"""DTW heterogeneity: per-breath scores, inter-patient similarity, cohort
pickers.

Counterpart of ``deepards_tpu/dtw/lib.py`` on numpy (no pandas): every
scoring task is flattened into padded pair batches and dispatched to the
batched DTW of ``deepards_tpu_torch.ops.dtw`` on ``device`` (default: the
card, where the CUDA kernel runs).  The JAX package's frames become arrays:
a patient's scores are a ``DTWFrame``, the inter-patient matrix a
``PatientDistances``, and the pandas orders the pickers rely on (patients
by first window, candidates sorted, quicksort ranks, first maximum) are
reproduced on those arrays.
"""
import json
import os
import time
import warnings
from typing import NamedTuple

import numpy as np
import torch

from deepards_tpu_torch.device import resolve_device
from deepards_tpu_torch.ops.dtw import dtw_batch


class DTWFrame(NamedTuple):
    """Per-breath rolling DTW of one patient, one entry per breath."""

    index: np.ndarray  # the breath's window (observation) index
    dtw: np.ndarray    # rolling DTW score, NaN where undefined
    hour: np.ndarray   # hour of the breath's prediction row, NaN if none


class PatientDistances:
    """A symmetric inter-patient distance matrix labelled by patient id."""

    def __init__(self, patients, values):
        self.patients = [str(p) for p in patients]
        self.values = np.asarray(values, np.float64)
        self._pos = {p: i for i, p in enumerate(self.patients)}

    def __contains__(self, patient):
        return patient in self._pos

    def positions(self, patients):
        return [self._pos[p] for p in patients]

    def subset(self, keep):
        """The matrix over the patients ``keep``, in that order."""
        pos = self.positions(keep)
        return PatientDistances(keep, self.values[np.ix_(pos, pos)])

    def save(self, path):
        """``patients`` and ``values`` as an ``.npz``."""
        np.savez(path, patients=np.asarray(self.patients),
                 values=self.values)


class SweepTimer:
    """Per-chunk times of ``batched_dtw_pairs``, for a caller that passes
    one: host seconds building the padded chunk (``pad_s``), host seconds
    of its copy to the device with a synchronise (``copy_s``), and on a
    card the kernel's milliseconds between CUDA events (``kernel_ms``).
    The first ``keep`` pairs of the first chunk are kept on the device
    with their distances (``kept``: a, b, la, lb, distances)."""

    def __init__(self, keep=0):
        self.keep = keep
        self.pad_s = []
        self.copy_s = []
        self.kept = None
        self._events = []

    @property
    def kernel_ms(self):
        return [start.elapsed_time(end) for start, end in self._events]

    def run(self, padded, device):
        """Copy one padded chunk to ``device`` and score it there."""
        t0 = time.perf_counter()
        a, b, la, lb = (torch.as_tensor(x, device=device) for x in padded)
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        self.copy_s.append(time.perf_counter() - t0)
        if device.type == "cuda":
            events = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
            events[0].record()
        d = dtw_batch(a, b, la, lb, device=device)
        if device.type == "cuda":
            events[1].record()
            self._events.append(events)
        if self.kept is None and self.keep:
            k = self.keep
            self.kept = tuple(t[:k].clone() for t in (a, b, la, lb, d))
        return d


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
        # a slice copy a row: no index arrays of every element
        dst = np.zeros((padded_bsz, n), np.float32)
        lens = np.ones(padded_bsz, np.int32)
        for r, s in enumerate(seqs):
            s = np.asarray(s, np.float32).ravel()
            dst[r, :len(s)] = s
            lens[r] = len(s)
        return dst, lens

    a, la = fill(seqs_a)
    b, lb = fill(seqs_b)
    return a, b, la, lb


# a ``SweepTimer`` that records the chunks of every ``batched_dtw_pairs``
# call given none, for a caller that times a path whose functions take no
# timer (``chip_smoke.py`` times training's DTW preprocessing so)
TIMER = None


def batched_dtw_pairs(seqs_a, seqs_b, chunk=8192, device=None, timer=None):
    """DTW distance for each (seqs_a[i], seqs_b[i]) pair; ragged input.

    Pairs run in length-sorted order, so one long outlier widens one
    chunk rather than every chunk, in chunks of up to ``chunk`` pairs
    padded by ``_pad_pairs``.  Results are scattered back to input order;
    each pair's DP is independent, so values do not depend on chunking or
    sorting.  ``timer``: a ``SweepTimer`` that records each chunk
    (``TIMER`` where none is given).
    """
    device = resolve_device(device)
    if timer is None:
        timer = TIMER
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
        t0 = time.perf_counter()
        padded = _pad_pairs(
            [seqs_a[i] for i in idx], [seqs_b[i] for i in idx]
        )
        if timer is None:
            d = dtw_batch(*padded, device=device)
        else:
            timer.pad_s.append(time.perf_counter() - t0)
            d = timer.run(padded, device)
        out[idx] = d[: len(idx)].cpu().numpy().astype(np.float64)
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


def dtw_analyze(pt_data, n_breaths, rolling_av_len, obs_index, hours,
                device=None):
    """Per-breath rolling DTW over a patient's window sequence, aligned
    with prediction hours (reference: dtw_lib.py:338-372).

    ``obs_index``, ``hours``: the prediction rows' window indices and
    hours (several rows may share a window).  Window k of ``pt_data`` takes
    the k-th distinct index, in order of first appearance, and its breaths
    cycle through that index's hours."""
    obs_index = np.asarray(obs_index)
    hours = np.asarray(hours, np.float64)
    obs_ids = list(dict.fromkeys(obs_index.tolist()))
    breaths, idx, hrs = [], [], []
    for k, seq in enumerate(pt_data):
        cur = obs_ids[k] if k < len(obs_ids) else k
        cur_hours = hours[obs_index == cur].tolist()
        for j, breath in enumerate(np.asarray(seq)):
            breaths.append(np.asarray(breath).ravel())
            idx.append(cur)
            hrs.append(cur_hours[j % len(cur_hours)] if cur_hours
                       else np.nan)
    scores = per_breath_dtw_scores(breaths, n_breaths, device=device)
    hrs = np.asarray(hrs, np.float64)
    hrs[:n_breaths] = np.nan
    if rolling_av_len > 1:
        kern = np.ones(rolling_av_len) / rolling_av_len
        rolled = np.convolve(scores, kern, mode="valid")
        scores = np.append([np.nan] * (rolling_av_len - 1), rolled)
    return DTWFrame(np.asarray(idx, np.int64), scores, hrs)


def as_columns(rows):
    """Prediction rows (a list of dicts with the same keys) as columns:
    {key: numpy array}."""
    keys = list(rows[0]) if rows else ["index", "hour", "patient"]
    return {k: np.asarray([r[k] for r in rows]) for k in keys}


def analyze_patient(patient_id, dataset, cache_dir, preds_by_hour,
                    n_breaths=3, rolling_len=1, device=None):
    """A patient's ``DTWFrame`` with an on-disk cache
    (reference: dtw_lib.py:375-409).

    ``preds_by_hour``: prediction columns ``index``, ``hour`` and
    ``patient`` (``as_columns`` of ``DeepARDSResults.pred_to_hour_frame``,
    or ``eval.plots.process_pred_to_hour_for_dtw``), or None for the
    windows' own hours.  The cache file's name carries every input that
    changes the scores, as the JAX package's does: patient, n_breaths,
    rolling_len, dataset_type, n_sub_batches and the split mode (filters
    act after the cache's raw windows)."""
    pt_dir = os.path.join(cache_dir, str(patient_id))
    os.makedirs(pt_dir, exist_ok=True)
    # kfold_num 0 names "holdout", as in the JAX package
    split_type = "kfold" if dataset.kfold_num else "holdout"
    path = os.path.join(pt_dir, "{}_n{}_rolling{}_{}_nb{}_{}.npz".format(
        patient_id, n_breaths, rolling_len, dataset.dataset_type,
        dataset.n_sub_batches, split_type))
    if os.path.exists(path):
        with np.load(path) as z:
            return DTWFrame(z["index"], z["dtw"], z["hour"])

    gt = dataset.get_ground_truth()
    pt_obs_idx = gt.index[gt.patient == patient_id]
    pt_data = [dataset.cache.data[int(i)] for i in pt_obs_idx]
    if preds_by_hour is None:
        obs, hours = pt_obs_idx, dataset.cache.hours[pt_obs_idx, 0]
    else:
        mine = np.asarray(preds_by_hour["patient"]) == patient_id
        obs = np.asarray(preds_by_hour["index"])[mine]
        hours = np.asarray(preds_by_hour["hour"])[mine]
    frame = dtw_analyze(pt_data, n_breaths, rolling_len, obs, hours,
                        device=device)
    np.savez(path, **frame._asdict())
    return frame


def build_patient_score_map(dataset, cache_dir=None, device=None):
    """Window-level mean rolling DTW (3 breaths back), the scores the
    homogeneity undersampler reads (reference consumes
    dtw_cache/patient_score_map.pkl, deepards/dataset.py:45-75).  Returns
    {window_index: score}; with ``cache_dir`` also writes it there as
    ``patient_score_map.json``."""
    gt = dataset.get_ground_truth()
    s = dataset.cache.data.shape[1]
    score_map = {}
    for pt in gt.patients():
        idxs = gt.index[gt.patient == pt]
        flat = [b for i in idxs
                for b in dataset.cache.data[int(i)].reshape(
                    -1, dataset.seq_len)]
        scores = per_breath_dtw_scores(flat, 3, device=device)
        with warnings.catch_warnings():  # a window of NaN scores only
            warnings.simplefilter("ignore", RuntimeWarning)
            per_window = np.nanmean(scores.reshape(len(idxs), s), axis=1)
        for i, idx in enumerate(idxs):
            if not np.isnan(per_window[i]):
                score_map[int(idx)] = float(per_window[i])
    if cache_dir:
        os.makedirs(cache_dir, exist_ok=True)
        with open(os.path.join(cache_dir, "patient_score_map.json"),
                  "w") as f:
            json.dump({str(k): v for k, v in score_map.items()}, f)
    return score_map


def _sorted_truth(dataset):
    """Window index, patient and class of the dataset's current windows by
    ascending index (``sort_index``: duplicates carry equal rows)."""
    gt = dataset.get_ground_truth()
    order = np.argsort(gt.index, kind="stable")
    return gt.index[order], gt.patient[order], gt.y[order]


def patho_by_patient(dataset):
    """{patient: class of its first window by ascending index}, keys
    sorted (``groupby("patient").y.first()``)."""
    _, patient, y = _sorted_truth(dataset)
    first = {}
    for p, label in zip(patient.tolist(), y.tolist()):
        first.setdefault(p, int(label))
    return {p: first[p] for p in sorted(first)}


def find_patient_similarity(dataset, results_path=None,
                            dist_method="same_ordered", n_random=50,
                            rng=None, device=None, timer=None):
    """Inter-patient DTW distance matrix (reference: dtw_lib.py:185-307):
    the mean DTW over pairs of whole windows (raveled, n = S x L) of each
    two patients, the first m of each (``same_ordered``) or ``n_random``
    drawn from each without replacement (``random``).  Every pair of the
    cohort goes through ``batched_dtw_pairs`` on ``device`` in one sweep.
    Patients are ordered by their first window.  ``results_path``: where
    to save the matrix (``.npz``)."""
    rng = rng or np.random.default_rng(0)
    index, patient, _ = _sorted_truth(dataset)
    pts = list(dict.fromkeys(patient.tolist()))
    rows_of = {pt: index[patient == pt] for pt in pts}
    data = dataset.cache.data

    pairs_a, pairs_b, spans = [], [], []
    for i, pt in enumerate(pts):
        for j in range(i + 1, len(pts)):
            rows_a, rows_b = rows_of[pt], rows_of[pts[j]]
            if dist_method == "same_ordered":
                m = min(len(rows_a), len(rows_b))
                idx_a, idx_b = rows_a[:m], rows_b[:m]
            elif dist_method == "random":
                n = min(n_random, len(rows_a), len(rows_b))
                idx_a = rng.choice(rows_a, n, replace=False)
                idx_b = rng.choice(rows_b, n, replace=False)
            else:
                raise ValueError(
                    'dist_method must be "random" or "same_ordered"')
            start = len(pairs_a)
            pairs_a += [data[int(ia)].ravel() for ia in idx_a]
            pairs_b += [data[int(ib)].ravel() for ib in idx_b]
            spans.append((i, j, start, len(pairs_a)))
    dists = batched_dtw_pairs(pairs_a, pairs_b, device=device,
                              timer=timer).tolist()
    values = np.zeros((len(pts), len(pts)))
    for i, j, start, stop in spans:
        if stop > start:
            # summed in pair order, as the JAX package sums
            values[i, j] = values[j, i] = sum(dists[start:stop]) / (
                stop - start)
    mat = PatientDistances(pts, values)
    if results_path:
        mat.save(results_path)
    return mat


def eval_set_for_candidacy(candidate, existing_sets, mean_similarity_thresh):
    """Candidate accepted if its mean patient overlap with already-accepted
    sets stays below the threshold (reference: dtw_lib.py pickers)."""
    if not existing_sets:
        return True
    overlaps = [
        len(set(candidate) & set(s)) / float(len(candidate))
        for s in existing_sets
    ]
    return float(np.mean(overlaps)) < mean_similarity_thresh


def pick_dissimilar_pts(dist_data, main_dataset, n_pts, exclude=None,
                        retrieve_n=1, mean_similarity_thresh=0.8):
    """Greedy max-distance patient sets with patho alternation
    (reference: dtw_lib.py:50-106).  Returns [[cost, patients], ...],
    costliest first."""
    patho = patho_by_patient(main_dataset)
    _, patient, _ = _sorted_truth(main_dataset)
    patients = list(dict.fromkeys(patient.tolist()))
    if exclude:
        excluded = set(exclude)
        patients = [p for p in patients if p not in excluded]
        dist_data = dist_data.subset(patients)
    by_class = {k: [p for p, y in patho.items() if y == k] for k in (0, 1)}

    candidate_sets = []
    for patient in patients:
        picked = [patient]
        for i in range(n_pts - 1):
            # patients of the other class in turn, sorted, not yet picked
            cands = [c for c in by_class[(patho[patient] + i + 1) % 2]
                     if c not in picked and c in dist_data]
            if not cands:
                break
            sums = dist_data.values[np.ix_(
                dist_data.positions(cands),
                dist_data.positions(picked))].sum(axis=1)
            picked.append(cands[int(np.argmax(sums))])
        pos = dist_data.positions(picked)
        cost = float(dist_data.values[np.ix_(pos, pos)][
            np.triu_indices(len(picked), 1)].sum())
        candidate_sets.append([cost, picked])
    best = []
    for g in sorted(candidate_sets, key=lambda x: -x[0]):
        if eval_set_for_candidacy(
            g[1], [b[1] for b in best], mean_similarity_thresh
        ):
            best.append(g)
        if len(best) == retrieve_n:
            break
    return best


def _nearest(row, dist_data, patients, k):
    """The ``k`` of ``patients`` nearest by ``row``, ranked as pandas'
    ``sort_values`` ranks them (an unstable quicksort)."""
    vals = row[dist_data.positions(patients)]
    return [patients[j] for j in np.argsort(vals, kind="quicksort")[:k]]


def pick_similar_pts(dist_data, main_dataset, n_pts, exclude=None,
                     retrieve_n=1, mean_similarity_thresh=0.8):
    """Medoid-ball search for maximally similar patho-balanced sets
    (reference: dtw_lib.py:108-165).  Returns [(cost, patients), ...],
    cheapest first."""
    if retrieve_n < 1:
        raise ValueError("retrieve_n cannot be set < 1!")
    if not (0 < mean_similarity_thresh <= 1):
        raise ValueError("mean_similarity_thresh must be between 0 and 1!")
    patho = patho_by_patient(main_dataset)
    if exclude:
        excluded = set(exclude)
        dist_data = dist_data.subset(
            [p for p in dist_data.patients if p not in excluded])

    arr = dist_data.values
    cols = dist_data.patients
    per_class = n_pts // 2
    candidates = []
    max_d = float(arr.max())
    # balls of growing radius around each patient, in steps of 1000
    for val in range(1000, int(max_d + 1000) + 1, 1000):
        for i in range(len(arr)):
            mask = arr[i] < val
            if mask.sum() < n_pts:
                continue
            pts = [cols[j] for j in np.flatnonzero(mask)]
            normals = [p for p in pts if patho[p] == 0]
            ards = [p for p in pts if patho[p] == 1]
            if len(normals) < per_class or len(ards) < per_class:
                continue
            best_n = _nearest(arr[i], dist_data, normals, per_class)
            best_a = _nearest(arr[i], dist_data, ards, per_class)
            cost = float(arr[i][dist_data.positions(best_n + best_a)].sum())
            if eval_set_for_candidacy(
                best_a + best_n, [c[1] for c in candidates],
                mean_similarity_thresh,
            ):
                candidates.append((cost, best_a + best_n))
        if len(candidates) >= retrieve_n:
            break
    return sorted(candidates, key=lambda x: x[0])[:retrieve_n]


class MedoidClusters(NamedTuple):
    """Patients sorted by id with their class and KMedoids cluster."""

    patient: list
    y: np.ndarray
    clust: np.ndarray


def mediod_process(dist_data, nclusts, main_dataset):
    """KMedoids clustering of the distance matrix
    (reference: dtw_lib.py:167-183)."""
    from deepards_tpu_torch.dtw.kmedoids import KMedoids

    patho = patho_by_patient(main_dataset)
    km = KMedoids(nclusts, metric="precomputed")
    km.fit(dist_data.values)
    clust = km.predict(dist_data.values)
    patients = list(patho)
    return MedoidClusters(
        patients, np.asarray([patho[p] for p in patients]),
        clust[dist_data.positions(patients)])
