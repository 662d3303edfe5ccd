"""Frequency-domain GradCAM studies.

Counterpart of ``deepards_tpu/explain/frequency_analytics.py``
(reference: deepards/gradcam.py:236-266, 376-1093): the FFT splice and
mask helpers, the per-fold cam sweep, and the studies ``one_d_analytics``
(cam intensity by frequency, input bands, the high-frequency splice),
``two_d_analytics``, ``butterworth_1d_analytics`` (with its median
prototypes), ``butter_plots`` and ``one_two_d_comparison``.

The JAX package's DataFrames are columns here: a dict of numpy arrays
under the frame's column names.  The sweep draws the windows with the JAX
package's generator calls, then cams each fold's picks in batches through
``explain.gradcam``, where each window keeps its own normalization group,
so a batch gives what one call a window gives.  Nothing here draws: the
``draw_*`` functions import matplotlib inside themselves and run on the
CPU host only (the card's machine has no matplotlib).
"""
import os
from dataclasses import dataclass, field
from typing import Dict, List

import numpy as np
import torch

from deepards_tpu_torch.data.pipeline import gather_pipeline, sosfilt
from deepards_tpu_torch.explain.gradcam import upsample_cam
from deepards_tpu_torch.utils import figures

CAM_BATCH = 64  # sequences a device pass in the sweep


def _columns(rows):
    """Row dicts as columns (none for no rows, as an empty frame has)."""
    return {k: np.asarray([r[k] for r in rows]) for k in (rows[0] if rows
                                                         else ())}


def _concat(parts):
    """Column dicts concatenated in order (``pd.concat``)."""
    return {k: np.concatenate([p[k] for p in parts]) for k in parts[0]}


# ---- fft helpers (reference: gradcam.py:236-266) ---------------------------

def cam_process(cam, target_len=224, normalize=True):
    """A cam resized to ``target_len`` on its last axis (``upsample_cam``,
    float32) and, with ``normalize``, scaled to [0, 1] in float64
    (reference ``cam_process``, gradcam.py:236-245)."""
    cam = np.asarray(upsample_cam(np.asarray(cam, np.float64), target_len),
                     np.float64)
    if normalize:
        cam = cam - cam.min()
        mx = cam.max()
        cam = cam / (mx if mx else 1.0)
    return cam


def get_fft(seq):
    """The complex shifted spectrum of an FFT window's (real, imag)
    channel pair (reference: gradcam.py:247-252)."""
    seq = np.asarray(seq)
    return seq[:, 0, :] + 1j * seq[:, 1, :]


def fft_to_ts(seq):
    """(reference: gradcam.py:254-258)"""
    return np.fft.ifft(np.fft.ifftshift(get_fft(seq), axes=-1), axis=-1)


def fft_to_ts_with_mask(seq, mask):
    """The waveform of the frequency bins ``mask`` keeps
    (reference: gradcam.py:261-265)."""
    fft = get_fft(seq) * np.asarray(mask)
    return np.fft.ifft(np.fft.ifftshift(fft, axes=-1), axis=-1)


def splice_frequencies(dst_seq, src_seq, freq_mask):
    """``dst_seq`` with its bins under the boolean (L,) ``freq_mask``
    taken from ``src_seq``: FFT windows (S, 2, L) (reference:
    gradcam.py:689-703)."""
    dst = np.array(dst_seq, copy=True)
    src = np.asarray(src_seq)
    num_mask = np.argwhere(np.asarray(freq_mask)).ravel()
    dst[:, :, num_mask] = src[:, :, num_mask]
    return dst


def representative_index(cams):
    """The row nearest (L2) to the mean cam (reference:
    gradcam.py:967-973)."""
    cams = np.asarray(cams, np.float64)
    avg = np.nanmean(cams, axis=0)
    return int(((cams - avg) ** 2).sum(
        axis=tuple(range(1, cams.ndim))).argmin())


def zero_high_freq_sanity(seq, freqs, hz=15.0):
    """The window with every bin at or above ``hz`` set to 0
    (reference: gradcam.py:705-712)."""
    mask = ~(np.abs(np.asarray(freqs)) >= hz)
    out = np.array(seq, copy=True)
    out[:, :, ~mask] = 0.0
    return out


# ---- cam collection ---------------------------------------------------------

def _by_patho():
    return {0: [], 1: []}


@dataclass
class StudyCams:
    """Cams collected by predicted class across folds."""

    cams: Dict[int, List[np.ndarray]] = field(default_factory=_by_patho)
    seq_idxs: Dict[int, List[int]] = field(default_factory=_by_patho)
    model_outs: Dict[int, List[np.ndarray]] = field(default_factory=_by_patho)
    kfold_idxs: Dict[int, List[tuple]] = field(default_factory=_by_patho)
    inputs_by_truth: Dict[int, List[np.ndarray]] = field(
        default_factory=_by_patho)

    def as_arrays(self, patho):
        return np.asarray(self.cams[patho], np.float64)


def sequence_cams(gen, windows, targets, batch=CAM_BATCH):
    """``gen.generate_cams_batch`` over ``windows`` (N, S, C, L) in batches
    of ``batch``: (N, L') cams and (N, 2) outputs."""
    cams, outs = [], []
    for start in range(0, len(windows), batch):
        c, o = gen.generate_cams_batch(windows[start:start + batch],
                                       targets[start:start + batch])
        cams.append(c)
        outs.append(o)
    return np.concatenate(cams), np.concatenate(outs)


def _truth_of(gt, idx):
    """The class of window ``idx``'s first row (``gt.loc[idx].y``)."""
    return int(gt.y[np.flatnonzero(gt.index == idx)[0]])


def collect_study_cams(cam_factory, dataset, models_by_fold, n_samps=50,
                       target_len=224, normalize=True, seed=0, cam_rows=None):
    """The per-fold cam sweep of every study (reference:
    gradcam.py:404-443/509-545/903-940): for each fold, its cam
    generator (``cam_factory(models_by_fold[fold])``), ``n_samps`` windows
    drawn as the JAX package draws them (all of them when there are
    fewer), each cammed at its class and filed by the PREDICTED class.
    ``cam_rows``: each 1D cam repeated as that many rows first (the 2D
    study)."""
    rng = np.random.default_rng(seed)
    study = StudyCams()
    for fold, model in models_by_fold.items():
        dataset.set_kfold_indexes_for_fold(fold)
        pipeline = gather_pipeline(dataset)
        gen = cam_factory(model)
        gt = dataset.get_ground_truth()
        if n_samps >= len(gt.index):
            picks = [int(i) for i in gt.index]
        else:
            picks = [int(gt.index[int(rng.integers(0, len(gt.index)))])
                     for _ in range(n_samps)]
        truths = np.asarray([_truth_of(gt, idx) for idx in picks])
        windows = pipeline(dataset.cache.data[np.asarray(picks, np.int64)])
        cams, outs = sequence_cams(gen, windows, truths)
        for idx, truth, window, cam, out in zip(picks, truths, windows,
                                                cams, outs):
            if cam_rows:
                cam = np.repeat(np.asarray(cam, np.float64)[None], cam_rows,
                                axis=0)
            pred = int(np.asarray(out).argmax())
            study.cams[pred].append(cam_process(cam, target_len, normalize))
            study.seq_idxs[pred].append(idx)
            study.model_outs[pred].append(np.asarray(out).ravel())
            study.kfold_idxs[pred].append((fold, idx))
            study.inputs_by_truth[int(truth)].append(window)
    return study


# ---- columns (the frames of the studies) ------------------------------------

def cam_intensity_frame(study, freqs=None, target_len=224):
    """Columns ``Cam Intensity``, ``Frequency``, ``Patho``: every cam value
    with its frequency (or position), ARDS first (reference:
    gradcam.py:446-455, 589-594, 941-946)."""
    if freqs is None:
        freqs = np.arange(target_len, dtype=np.float64)
    parts = []
    for patho in (1, 0):
        cams = study.as_arrays(patho)
        if cams.size == 0:
            continue
        cams2 = cams.reshape(len(cams), -1)
        reps = cams2.shape[1] // len(freqs)
        parts.append({
            "Cam Intensity": cams2.ravel(),
            "Frequency": np.tile(np.repeat(freqs[None], reps, 0).ravel(),
                                 len(cams)),
            "Patho": np.full(cams2.size, patho)})
    return _concat(parts)


def frequency_band_frame(study, idx_jump=14, target_len=224):
    """Columns ``val``, ``freq``, ``patho``: the first channel of the
    inputs by class, band by band of ``idx_jump`` bins (reference:
    gradcam.py:552-563)."""
    parts = []
    for patho in (1, 0):
        imgs = study.inputs_by_truth[patho]
        if not imgs:
            continue
        arr = np.asarray(imgs, np.float64)  # (N, S, C, L)
        for start in range(0, target_len, idx_jump):
            vals = arr[..., 0, start:start + idx_jump].ravel()
            parts.append({"val": vals, "freq": np.full(vals.size, start),
                          "patho": np.full(vals.size, patho)})
    return _concat(parts)


# ---- the studies ------------------------------------------------------------

def fft_freqs(target_len=224, fs=50.0):
    return np.fft.fftshift(np.fft.fftfreq(target_len, d=1.0 / fs))


def one_d_analytics(cam_factory, dataset, models_by_fold, n_samps=50,
                    fs=50.0, target_len=224, seed=0):
    """The 1D FFT model's study (reference: gradcam.py:474-745): cam
    intensity by frequency, the inputs by frequency band, and the
    high-frequency splice on confident ARDS predictions.  Returns
    {intensity, bands, splices} (columns) and the ``study``."""
    freqs = fft_freqs(target_len, fs)
    study = collect_study_cams(cam_factory, dataset, models_by_fold,
                               n_samps, target_len, normalize=True,
                               seed=seed)
    return {
        "intensity": cam_intensity_frame(study, freqs, target_len),
        "bands": frequency_band_frame(study, 14, target_len),
        "splices": splice_experiment(cam_factory, dataset, models_by_fold,
                                     study, freqs, seed=seed),
        "study": study,
    }


def splice_experiment(cam_factory, dataset, models_by_fold, study, freqs,
                      hz=15.0, conf=0.95, max_pairs=5, seed=0):
    """The high-frequency splice (reference: gradcam.py:678-703): for each
    window predicted ARDS with softmax above ``conf``, its bins at or
    above ``hz`` spliced into a drawn window predicted other, with that
    window's model's outputs before and after.  Columns ``ards_idx``,
    ``other_idx``, ``before_ards_logit``, ``after_ards_logit``,
    ``flipped`` (none when no window was predicted other).  The draws are
    the JAX package's; each model's pairs run as one batch."""
    rng = np.random.default_rng(seed)
    freq_mask = np.abs(freqs) >= hz
    if not study.kfold_idxs[0]:
        return {}
    pipes = {}

    def pipe_for(fold):
        if fold not in pipes:
            dataset.set_kfold_indexes_for_fold(fold)
            pipes[fold] = gather_pipeline(dataset)
        return pipes[fold]

    pairs = []  # (ards idx, other fold, other idx, other, spliced)
    for i, out in enumerate(study.model_outs[1]):
        ex = np.exp(out - out.max())
        if (ex / ex.sum())[1] <= conf:
            continue
        fold, idx = study.kfold_idxs[1][i]
        seq = pipe_for(fold)(dataset.cache.data[idx])
        o_fold, o_idx = study.kfold_idxs[0][
            int(rng.integers(0, len(study.kfold_idxs[0])))]
        other = pipe_for(o_fold)(dataset.cache.data[o_idx])
        pairs.append((idx, o_fold, o_idx, other,
                      splice_frequencies(other, seq, freq_mask)))
        if len(pairs) >= max_pairs:
            break
    outs = {}
    for o_fold in dict.fromkeys(p[1] for p in pairs):
        mine = [k for k, p in enumerate(pairs) if p[1] == o_fold]
        xs = np.stack([pairs[k][3] for k in mine]
                      + [pairs[k][4] for k in mine])
        _, o = sequence_cams(cam_factory(models_by_fold[o_fold]), xs,
                             np.zeros(len(xs), np.int64))
        for j, k in enumerate(mine):
            outs[k] = (o[j], o[len(mine) + j])
    return _columns([{
        "ards_idx": idx, "other_idx": o_idx,
        "before_ards_logit": float(outs[k][0][1]),
        "after_ards_logit": float(outs[k][1][1]),
        "flipped": bool(outs[k][1].argmax() == 1),
    } for k, (idx, _, o_idx, _, _) in enumerate(pairs)])


def two_d_analytics(cam_factory, dataset, models_by_fold, n_samps=50,
                    fs=50.0, target_len=224, seed=0):
    """The "2D" study (reference: gradcam.py:376-471) as the JAX package
    runs it: the 1D network's whole-sequence cam repeated over
    ``target_len`` rows (``deepards_tpu/explain/frequency_analytics.py:
    358-369``), resized to (L, L) unnormalized, its intensity by
    frequency.  No 2D network runs.  Returns {intensity} and the
    ``study``."""
    study = collect_study_cams(cam_factory, dataset, models_by_fold,
                               n_samps, target_len, normalize=False,
                               seed=seed, cam_rows=target_len)
    return {"intensity": cam_intensity_frame(
        study, fft_freqs(target_len, fs), target_len), "study": study}


def filtered_rows(dataset, seq):
    """``seq`` through ``dataset``'s own Butterworth filter (``sosfilt``
    on the host, float32), or as it is without one."""
    from deepards_tpu_torch.data.pipeline import design_butter_sos

    sos = design_butter_sos(dataset.butter_low, dataset.butter_high)
    if sos is None:
        return seq
    return sosfilt(sos, torch.as_tensor(seq, dtype=torch.float32)).numpy(
        ).astype(np.float64)


def butterworth_1d_analytics(cam_factory, dataset, dataset_no_filter,
                             models_by_fold, n_samps=50, target_len=224,
                             seed=0):
    """The band-filtered study (reference: gradcam.py:878-1054): cam
    intensity by position, then for each class the window whose cam is
    nearest the mean cam, its median over breaths filtered (by the
    dataset's own filter) and unfiltered, and the mean cam.  Returns
    {intensity (columns), prototypes ({(patho, tag): array}), study}."""
    study = collect_study_cams(cam_factory, dataset, models_by_fold,
                               n_samps, target_len, normalize=True,
                               seed=seed)
    protos = {}
    for patho in (1, 0):
        cams = study.as_arrays(patho)
        if cams.size == 0:
            continue
        fold, idx = study.kfold_idxs[patho][representative_index(cams)]
        for tag, dat in (("filtered", dataset),
                         ("no_filter", dataset_no_filter)):
            dat.set_kfold_indexes_for_fold(fold)
            # the cache's rows are raw: the filtered panel goes through
            # the dataset's filter
            seq = np.asarray(dat.cache.data[idx], np.float64)
            if tag == "filtered":
                seq = filtered_rows(dat, seq)
            protos[(patho, tag)] = np.median(seq, axis=0).ravel()
        protos[(patho, "mean_cam")] = np.nanmean(cams, axis=0).ravel()
    return {"intensity": cam_intensity_frame(study, None, target_len),
            "prototypes": protos, "study": study}


def butter_sos(hz_low, hz_high, fs=50.0):
    """The band plot's 10th-order Butterworth SOS (reference:
    gradcam.py:1062-1093)."""
    from scipy.signal import butter

    if hz_low == 0:
        return butter(10, hz_high, fs=fs, output="sos", btype="lowpass")
    if hz_high >= fs / 2:
        return butter(10, hz_low, fs=fs, output="sos", btype="highpass")
    return butter(10, (hz_low, hz_high), fs=fs, output="sos",
                  btype="bandpass")


def butter_plots(dataset_no_filter, index, hz_low, hz_high, fold=0,
                 breath_idx=None, fs=50.0, seed=0):
    """One breath of window ``index`` (a drawn one unless ``breath_idx``)
    through the band's filter, float32 (reference: gradcam.py:1062-1093):
    the signal the JAX package plots."""
    sos = np.asarray(butter_sos(hz_low, hz_high, fs), np.float32)
    dataset_no_filter.set_kfold_indexes_for_fold(fold)
    rng = np.random.default_rng(seed)
    seq = np.asarray(dataset_no_filter.cache.data[index], np.float64)
    if breath_idx is None:
        breath_idx = int(rng.integers(0, seq.shape[0]))
    row = torch.as_tensor(seq[breath_idx].ravel()[None], dtype=torch.float32)
    return sosfilt(sos, row).numpy()[0]


def one_two_d_comparison(cam_factory_1d, cam_factory_2d, dataset_1d,
                         dataset_2d, models_1d, models_2d, n_pairs=4,
                         target_len=224, seed=0):
    """1D against "2D" cams of drawn breaths (reference:
    gradcam.py:747-876): for each fold, windows drawn from its test
    truth, one breath each, the first generator's read cam of that breath
    and the second's whole-sequence cam, each resized and normalized,
    with both waveforms.  Returns one dict a pair: idx, breath, cam_1d,
    cam_2d, wave_1d, wave_2d."""
    rng = np.random.default_rng(seed)
    pairs = []
    for fold in sorted(models_1d):
        dataset_1d.set_kfold_indexes_for_fold(fold)
        dataset_2d.set_kfold_indexes_for_fold(fold)
        pipe1 = gather_pipeline(dataset_1d)
        pipe2 = gather_pipeline(dataset_2d)
        g1 = cam_factory_1d(models_1d[fold])
        g2 = cam_factory_2d(models_2d[fold])
        gt = dataset_1d.get_ground_truth()
        for _ in range(max(1, n_pairs // len(models_1d))):
            idx = int(gt.index[int(rng.integers(0, len(gt.index)))])
            seq1 = pipe1(dataset_1d.cache.data[idx])
            seq2 = pipe2(
                dataset_2d.cache.data[idx % len(dataset_2d.cache.data)])
            target = _truth_of(gt, idx)
            breath_n = int(rng.integers(0, seq1.shape[0]))
            cam1, _ = g1.generate_read_cam(seq1, target)
            cam2, _ = g2.generate_cam(seq2, target)
            pairs.append({
                "idx": idx, "breath": breath_n,
                "cam_1d": cam_process(cam1[breath_n], target_len, True),
                "cam_2d": cam_process(np.asarray(cam2, np.float64).ravel(),
                                      target_len, True),
                "wave_1d": np.asarray(seq1[breath_n]).ravel()[:target_len],
                "wave_2d": np.asarray(seq2).reshape(seq2.shape[0], -1)[
                    breath_n % seq2.shape[0]][:target_len]})
    return pairs


# ---- drawing: matplotlib, on the CPU host only ------------------------------

def _mean_iqr(ax, cols, x_col, y_col, hue_col, labels):
    """A mean line with an interquartile band per class."""
    for patho, label in labels.items():
        sel = cols[hue_col] == patho
        if not sel.any():
            continue
        xs, ys = cols[x_col][sel], cols[y_col][sel]
        grid = np.unique(xs)
        by_x = [ys[xs == x] for x in grid]
        ax.plot(grid, [v.mean() for v in by_x], label=label, lw=2)
        ax.fill_between(grid, [np.quantile(v, 0.25) for v in by_x],
                        [np.quantile(v, 0.75) for v in by_x], alpha=0.25)
    ax.legend()
    ax.grid(axis="y")


def draw_intensity(cols, out_path, xlabel, title=None, xlim=None):
    """Cam intensity by frequency (or position), by class, as a PNG."""
    plt = figures.pyplot()
    fig, ax = plt.subplots(figsize=(16, 10))
    _mean_iqr(ax, cols, "Frequency", "Cam Intensity", "Patho",
              {0: "Non-ARDS", 1: "ARDS"})
    ax.set_xlabel(xlabel, fontsize=16)
    ax.set_ylabel("Cam Intensity", fontsize=16)
    if xlim:
        ax.set_xlim(xlim)
    if title:
        ax.set_title(title, fontsize=18)
    fig.savefig(out_path, dpi=200, bbox_inches="tight")
    plt.close(fig)
    return out_path


def draw_bands(cols, freqs, out_path):
    """The inputs' first channel by frequency band and class, boxes."""
    plt = figures.pyplot()
    fig, ax = plt.subplots(figsize=(16, 10))
    starts = sorted(np.unique(cols["freq"]).tolist())
    for off, patho in enumerate((0, 1)):
        data = [cols["val"][(cols["freq"] == s) & (cols["patho"] == patho)]
                for s in starts]
        pos = np.arange(len(starts)) + (off - 0.5) * 0.35
        ax.boxplot(data, positions=pos, widths=0.3, showfliers=False)
    ax.set_xticks(np.arange(len(starts)))
    ax.set_xticklabels(["{}".format(round(freqs[s], 1)) for s in starts],
                       fontsize=10)
    ax.set_xlabel("Frequency Start", fontsize=16)
    ax.grid(axis="y")
    fig.savefig(out_path, dpi=200, bbox_inches="tight")
    plt.close(fig)
    return out_path


def draw_prototypes(protos, hz_low, hz_high, out_path):
    """The mean cams over the filtered prototypes, and the unfiltered
    ones, by class."""
    plt = figures.pyplot()
    fig, axes = plt.subplots(2, 2, figsize=(20, 10))
    for col, patho in enumerate((1, 0)):
        if (patho, "mean_cam") not in protos:
            continue
        ax = axes[0][col]
        ax.twinx().plot(protos[(patho, "filtered")], lw=2,
                        color="tab:green", label="Prototype")
        ax.plot(protos[(patho, "mean_cam")], lw=3, alpha=0.6,
                label="Mean Cam")
        ax.set_title("ARDS" if patho else "Non-ARDS")
        ax.grid(axis="y")
        axes[1][col].plot(protos[(patho, "no_filter")], lw=2,
                          label="Prototype No Filter")
        axes[1][col].grid(axis="y")
        axes[1][col].legend(loc="upper right")
    fig.suptitle("{}-{}Hz Cam and Mean Prototypes".format(hz_low, hz_high),
                 fontsize=18)
    fig.savefig(out_path, dpi=200, bbox_inches="tight")
    plt.close(fig)
    return out_path


def draw_signal(signal, out_path):
    """A filtered breath, bare, as a PNG."""
    plt = figures.pyplot()
    fig, ax = plt.subplots(figsize=(4, 4))
    ax.plot(signal, lw=1.35, label="flow")
    ax.grid(axis="y")
    ax.set_xticks([])
    ax.set_yticks([])
    for s in ("top", "left", "right", "bottom"):
        ax.spines[s].set_visible(False)
    fig.savefig(out_path, dpi=400, bbox_inches="tight", pad_inches=0.0)
    plt.close(fig)
    return out_path


def study_pngs(cmd, result, out_dir, experiment="butter", hz_low=None,
               hz_high=None, target_len=224, fs=50.0):
    """[(PNG path, draw function)] of a study's result: the PNG stages the
    CLI runs on the CPU host."""
    if cmd == "one-d":
        freqs = fft_freqs(target_len, fs)
        stages = [
            ("1d_cam_intensities.png", lambda p: draw_intensity(
                result["intensity"], p, "Frequency", xlim=(-25.2, 25.2))),
            ("fft_freq_box.png", lambda p: draw_bands(
                result["bands"], freqs, p))]
    elif cmd == "two-d":
        stages = [("2d_cam_unnormalized_intensities.png",
                   lambda p: draw_intensity(result["intensity"], p,
                                            "Frequency",
                                            xlim=(-25.2, 25.2)))]
    elif cmd == "butter":
        stem = "{}-{}-{}hz".format(experiment, hz_low, hz_high)
        stages = [
            (stem + "-gradcam.png", lambda p: draw_intensity(
                result["intensity"], p, "", title="{}-{}Hz Gradcam".format(
                    hz_low, hz_high))),
            (stem + "-prototypes.png", lambda p: draw_prototypes(
                result["prototypes"], hz_low, hz_high, p))]
    else:
        raise ValueError(cmd)
    return [(os.path.join(out_dir, name), draw) for name, draw in stages]
