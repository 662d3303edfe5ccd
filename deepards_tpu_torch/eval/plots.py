"""Per-breath predictions by hour, their DTW frames, and the
disease-evolution drawings.

Counterpart of ``deepards_tpu/eval/plots.py`` (reference:
deepards/metrics.py:396-570): the test predictions expanded to one row a
breath with the breath's hour, then each patient's rolling DTW frame
through ``dtw.lib.analyze_patient`` (the DTW kernel on the card).  The
JAX frames are columns here: a dict of numpy arrays under the frame's
column names.  The drawings read the results store's rows (no pandas):
each figure's arrays go to an ``.npz`` beside its PNG, and the PNG is
drawn with matplotlib on the CPU host only (``utils/figures.py``).
"""
import functools
import os
from math import ceil, sqrt

import numpy as np

from deepards_tpu_torch.dtw.lib import analyze_patient, as_columns
from deepards_tpu_torch.utils import figures


def process_pred_to_hour_for_dtw(pred_to_hour_frame, dataset):
    """Each prediction row repeated S times, one a breath of its window,
    each with its breath's hour: the window's S hours of
    ``dataset.cache.hours`` resized to S as ``np.resize`` does
    (reference: metrics.py:396-423).  Returns columns."""
    cols = as_columns(pred_to_hour_frame)
    repeat_n = dataset.cache.data.shape[1]
    index = np.asarray(cols["index"], np.int64)
    out = {k: np.repeat(np.asarray(v), repeat_n)
           for k, v in cols.items() if k != "hour"}
    hours = dataset.cache.hours[index].astype(np.float64)
    if hours.shape[1] != repeat_n:
        hours = np.stack([np.resize(h, repeat_n) for h in hours])
    out["hour"] = hours.reshape(-1)
    return out


def perform_dtw_preprocessing(results, test_dataset, cache_dir="dtw_cache",
                              device=None):
    """{patient: ``DTWFrame``} of the last predictions by hour
    (``results.pred_to_hour_frame``) on ``test_dataset``, one
    ``analyze_patient`` a patient in order of first appearance, each
    cached under ``cache_dir`` (reference: metrics.py:425-450)."""
    preds_by_hour = process_pred_to_hour_for_dtw(
        results.pred_to_hour_frame, test_dataset)
    return {pt: analyze_patient(pt, test_dataset, cache_dir, preds_by_hour,
                                device=device)
            for pt in dict.fromkeys(preds_by_hour["patient"].tolist())}


# -- the drawings (deepards_tpu/eval/plots.py:55-151) -------------------------


def hourly_vote_fracs(hours, preds):
    """Each hour 0..23's fraction of ARDS predictions, NaN for an hour
    with none: the bars of a patient's disease evolution."""
    hours = np.asarray(hours, np.float64)
    preds = np.asarray(preds)
    fracs = np.full(24, np.nan)
    for h0 in range(24):
        sel = preds[(hours >= h0) & (hours < h0 + 1)]
        if len(sel):
            fracs[h0] = sel.mean()
    return fracs


def _by_patient(frame):
    """Rows of ``pred_to_hour_frame`` by patient, patients sorted (as a
    pandas groupby orders them)."""
    groups = {}
    for row in frame:
        groups.setdefault(row["patient"], []).append(row)
    return {pt: groups[pt] for pt in sorted(groups)}


def _fracs_of(rows):
    return hourly_vote_fracs([r["hour"] for r in rows],
                             [r["pred"] for r in rows])


def plot_disease_evolution(fracs, ax, legend=True, fontsize=10, xylabel=True,
                           xy_visible=True):
    """The hourly ARDS-vote bars of ``hourly_vote_fracs`` on ``ax``
    (reference: metrics.py:452-480 style)."""
    colors = ["C1" if (not np.isnan(f) and f >= 0.5) else "C0"
              for f in fracs]
    ax.bar(np.arange(24), [0 if np.isnan(f) else f for f in fracs],
           width=0.9, color=colors)
    ax.set_ylim(0, 1)
    if xylabel:
        ax.set_xlabel("hour", fontsize=fontsize)
        ax.set_ylabel("ARDS vote frac", fontsize=fontsize)
    if not xy_visible:
        ax.set_xticks([])
        ax.set_yticks([])
    if legend:
        ax.axhline(0.5, color="k", ls="--", lw=0.5)
    return ax


def hourly_patient_data(results, dtw_frames=None):
    """{patient: the arrays behind its hourly plot}: ``fracs`` (24,),
    ``y``, and where its DTW frame has rows, ``dtw_hour`` and ``dtw``, the
    frame's breaths with both defined, by hour."""
    out = {}
    for pt, rows in _by_patient(results.pred_to_hour_frame).items():
        data = {"fracs": _fracs_of(rows), "y": int(rows[0]["y"])}
        frame = (dtw_frames or {}).get(pt)
        if frame is not None and len(frame.dtw):
            keep = ~(np.isnan(frame.dtw) | np.isnan(frame.hour))
            order = np.argsort(frame.hour[keep], kind="stable")
            data["dtw_hour"] = frame.hour[keep][order]
            data["dtw"] = frame.dtw[keep][order]
        out[pt] = data
    return out


def _draw_hourly(path, pt, data):
    plt = figures.pyplot()
    fig, ax = plt.subplots(figsize=(7, 3))
    plot_disease_evolution(data["fracs"], ax)
    if "dtw" in data:
        ax2 = ax.twinx()
        ax2.plot(data["dtw_hour"], data["dtw"], "g-", alpha=0.6, lw=0.8)
        ax2.set_ylabel("DTW", color="g")
    ax.set_title("patient {} ({})".format(
        pt, "ARDS" if data["y"] else "OTHER"))
    fig.savefig(path, dpi=120, bbox_inches="tight")
    plt.close(fig)
    return path


def perform_hourly_patient_plot(results, out_dir="prediction_plots",
                                dtw_frames=None, device="cpu"):
    """One hourly plot a patient, its DTW over it where there is a frame
    (reference: metrics.py:482-540): ``<out_dir>/<patient>.npz`` of
    ``hourly_patient_data``, and its ``.png`` where ``device`` is the CPU
    host and matplotlib is present.  Returns the PNGs drawn."""
    os.makedirs(out_dir, exist_ok=True)
    stages = []
    for pt, data in hourly_patient_data(results, dtw_frames).items():
        base = os.path.join(out_dir, str(pt))
        np.savez(base + ".npz", **data)
        stages.append((base + ".png", functools.partial(
            _draw_hourly, pt=pt, data=data)))
    return figures.draw_or_refuse(stages, device)


def tiled_groups(results):
    """{TP, TN, FP, FN: (patients, (n, 24) fracs)} of the last epoch's
    patient rows, patients in order of appearance, groups with none
    left out (reference: metrics.py:543-570)."""
    frame = results.pred_to_hour_frame
    last = max(r["epoch_num"] for r in results.results)
    latest = [r for r in results.results if r["epoch_num"] == last]
    cells = {"TP": (1, 1), "TN": (0, 0), "FP": (0, 1), "FN": (1, 0)}
    out = {}
    for title, (patho, prediction) in cells.items():
        pts = list(dict.fromkeys(
            r["patient"] for r in latest
            if r["patho"] == patho and r["prediction"] == prediction))
        if pts:
            out[title] = (pts, np.stack([_fracs_of(
                [r for r in frame if r["patient"] == pt]) for pt in pts]))
    return out


def _draw_tiled(path, title, pts, fracs):
    plt = figures.pyplot()
    layout = int(ceil(sqrt(len(pts))))
    fig = plt.figure(figsize=(2.2 * layout, 2.0 * layout))
    fig.suptitle(title)
    for i, (pt, pt_fracs) in enumerate(zip(pts, fracs)):
        ax = fig.add_subplot(layout, layout, i + 1)
        plot_disease_evolution(pt_fracs, ax, legend=False, fontsize=6,
                               xylabel=False, xy_visible=False)
        ax.set_title(str(pt), fontsize=6)
    fig.savefig(path, dpi=120, bbox_inches="tight")
    plt.close(fig)
    return path


def plot_tiled_disease_evol(results, out_path="prediction_plots/tiled.png",
                            device="cpu"):
    """A grid of patient evolutions for each of TP, TN, FP and FN:
    ``<out_path stem>_<group>.npz`` of its patients and fracs, and its
    ``.png`` where ``device`` is the CPU host and matplotlib is present
    (reference: metrics.py:543-570).  Returns the PNGs drawn."""
    os.makedirs(os.path.dirname(out_path) or ".", exist_ok=True)
    stages = []
    for title, (pts, fracs) in tiled_groups(results).items():
        base = "{}_{}".format(os.path.splitext(out_path)[0], title)
        np.savez(base + ".npz", patients=np.asarray(pts, str), fracs=fracs)
        stages.append((base + ".png", functools.partial(
            _draw_tiled, title=title, pts=pts, fracs=fracs)))
    return figures.draw_or_refuse(stages, device)
