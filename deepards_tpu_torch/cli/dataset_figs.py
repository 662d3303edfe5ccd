"""Dataset-type and filter illustration figures.

Counterpart of ``deepards_tpu/cli/dataset_figs.py`` (reference:
aim2_dl_v_rf_compr/main_graph_code.py): example windows of the dataset
type, one row a sub-batch, and a sample flow window under the
Butterworth lowpasses, the FFT band filters and the FFT downsampling
(main_graph_code.py:320-392), filtered by the port's batch transforms
(``data/pipeline.py``) on ``--device`` (default: the card; raises when
there is none).  Each figure's arrays go to an ``.npz``; the PNG beside
it is drawn with matplotlib on the CPU host only (``utils/figures.py``).

  python -m deepards_tpu_torch.cli.dataset_figs --train-from-pickle ds.npz \\
      -o dataset_figs [--n-examples 3] [--device cpu]
"""
import argparse
import functools
import os

import numpy as np
import torch

from deepards_tpu_torch.data.pipeline import (
    design_butter_sos,
    fft_band_filter,
    fft_resample,
    sosfilt,
)
from deepards_tpu_torch.device import resolve_device
from deepards_tpu_torch.utils import figures


def _remove_spines(ax):
    for side in ("top", "right", "left", "bottom"):
        ax.spines[side].set_visible(False)
    ax.set_xticks([])
    ax.set_yticks([])


def _draw_rows(path, rows):
    plt = figures.pyplot()
    fig, axes = plt.subplots(nrows=len(rows), figsize=(8, 1.2 * len(rows)))
    for ax, row in zip(np.atleast_1d(axes), rows):
        ax.plot(row, lw=0.8)
        _remove_spines(ax)
    fig.savefig(path, dpi=120, bbox_inches="tight", pad_inches=0.0)
    plt.close(fig)
    return path


def _draw_overlay(path, raw, filtered, label, raw_x=None, filtered_x=None):
    plt = figures.pyplot()
    fig, ax = plt.subplots(figsize=(6, 2.5))
    if raw_x is None:
        ax.plot(raw, lw=0.8, color="#888", label="raw")
        ax.plot(filtered, lw=0.9, label=label)
    else:
        ax.plot(raw_x, raw, lw=0.8, color="#888", label="raw")
        ax.plot(filtered_x, filtered, lw=0.9, label=label)
    _remove_spines(ax)
    ax.legend(frameon=False, fontsize=7)
    fig.savefig(path, dpi=120, bbox_inches="tight", pad_inches=0.0)
    plt.close(fig)
    return path


def _stage(out_dir, name, draw, **arrays):
    """``<out_dir>/<name>.npz`` of ``arrays``, and the (PNG path, draw)
    stage of its figure."""
    base = os.path.join(out_dir, name)
    np.savez(base + ".npz", **arrays)
    return base + ".png", functools.partial(draw, **arrays)


def window_stages(dataset, out_dir, n_examples=3):
    """One figure an example window: its first (up to) 5 sub-batch rows
    stacked (main_graph_code.py:91-316)."""
    stages = []
    for n, i in enumerate(dataset.current_indices()[:n_examples]):
        window = np.asarray(dataset.cache.data[int(i)])  # (S, C, L)
        stages.append(_stage(
            out_dir, "{}_{}".format(dataset.dataset_type, n + 1),
            _draw_rows, rows=window[:5, 0]))
    return stages


def butter_stages(flow, out_dir, cutoffs=(20, 15, 10, 6, 2)):
    """The flow and its Butterworth lowpass at each cutoff, the reference's
    frequencies (main_graph_code.py:320-375)."""
    raw = flow.cpu().numpy()
    return [_stage(out_dir, "butterworth-{}hz".format(hz), _draw_overlay,
                   raw=raw, label="butter lowpass {}hz".format(hz),
                   filtered=sosfilt(design_butter_sos(hz, None),
                                    flow).cpu().numpy())
            for hz in cutoffs]


def fft_filter_stages(flow, out_dir, bands=((0, 10), (0, 6), (0, 2))):
    """The flow and its FFT band filter at each band
    (main_graph_code.py:346-361)."""
    raw = flow.cpu().numpy()
    return [_stage(out_dir, "fft-filt-{}-{}hz".format(lo, hi), _draw_overlay,
                   raw=raw, label="fft {}-{}hz".format(lo, hi),
                   filtered=fft_band_filter(flow, lo, hi).cpu().numpy())
            for lo, hi in bands]


def downsample_stages(flow, out_dir, factors=(2.0, 4.0)):
    """The flow and its FFT downsampling by each factor, both over the
    window's span (main_graph_code.py:379-392)."""
    raw = flow.cpu().numpy()
    n = len(raw)
    stages = []
    for factor in factors:
        new_len = int(round(n / factor))
        stages.append(_stage(
            out_dir, "downsampled-{}x".format(factor), _draw_overlay,
            raw=raw, filtered=fft_resample(flow, new_len).cpu().numpy(),
            label="downsampled {}x".format(factor),
            raw_x=np.linspace(0, n, n), filtered_x=np.linspace(0, n, new_len)))
    return stages


def generate_all(dataset, out_dir, n_examples=3, device=None):
    """Every figure's ``.npz`` under ``out_dir``, the filters run on
    ``device`` (default: the card; ``"cpu"`` for the CPU); returns the
    PNGs drawn (none on the card)."""
    device = resolve_device(device)
    os.makedirs(out_dir, exist_ok=True)
    i = int(dataset.current_indices()[0])
    flow = torch.as_tensor(np.asarray(dataset.cache.data[i][0][0],
                                      np.float32), device=device)
    stages = (window_stages(dataset, out_dir, n_examples)
              + butter_stages(flow, out_dir)
              + fft_filter_stages(flow, out_dir)
              + downsample_stages(flow, out_dir))
    return figures.draw_or_refuse(stages, device)


def main(argv=None):
    parser = argparse.ArgumentParser(prog="deepards-dataset-figs-torch")
    parser.add_argument("--train-from-pickle", required=True)
    parser.add_argument("-o", "--out-dir", default="dataset_figs")
    parser.add_argument("--n-examples", type=int, default=3)
    parser.add_argument("--device",
                        help="torch device of the filters (default: cuda)")
    args = parser.parse_args(argv)

    from deepards_tpu_torch.data.dataset import ARDSRawDataset

    ds = ARDSRawDataset.from_pickle(args.train_from_pickle)
    if ds.total_kfolds:
        ds.set_kfold_indexes_for_fold(0)
    return generate_all(ds, args.out_dir, args.n_examples, args.device)


if __name__ == "__main__":
    main()
