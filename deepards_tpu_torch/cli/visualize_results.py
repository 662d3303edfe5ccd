"""Loss and AUC curves of saved meters.

Counterpart of ``deepards_tpu/cli/visualize_results.py`` (reference:
deepards/visualize_results.py:16-80):

  python -m deepards_tpu_torch.cli.visualize_results \\
      [--results-dir results] [--start-time T] [--metric test_auc] [-o png]

It reads the ``meters_deepards_start_<start time>.npz`` files the port's
trainer writes (``eval.metrics.Reporting.save_all``), one a run, and
plots each ``<metric>_fold_<k>`` meter with matplotlib (imported inside
``plot_meters``, on the CPU host).
"""
import argparse
import glob
import os

import numpy as np


def load_meters(results_dir, start_time=None):
    """{file name: {meter: values}} of the run started at ``start_time``,
    or of every run in ``results_dir``."""
    pattern = ("meters_deepards_start_{}.npz".format(start_time)
               if start_time else "meters_deepards_start_*.npz")
    paths = sorted(glob.glob(os.path.join(results_dir, pattern)))
    if not paths:
        raise FileNotFoundError("no meter files matching {} in {}".format(
            pattern, results_dir))
    out = {}
    for p in paths:
        with np.load(p) as z:
            out[os.path.basename(p)] = {k: z[k] for k in z.files}
    return out


def plot_meters(runs, metric, out):
    """Each run's ``<metric>_fold_<k>`` meters on one figure, as a PNG."""
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    fig, ax = plt.subplots(figsize=(8, 5))
    for run_name, meters in runs.items():
        for name, values in sorted(meters.items()):
            if name.startswith(metric + "_fold_"):
                ax.plot(values, label="{} {}".format(run_name[:20], name))
    ax.set_xlabel("update")
    ax.set_ylabel(metric)
    if ax.lines:
        ax.legend(fontsize=6)
    fig.savefig(out, dpi=120, bbox_inches="tight")
    plt.close(fig)
    return out


def main(argv=None):
    parser = argparse.ArgumentParser(prog="deepards-visualize-results-torch")
    parser.add_argument("--results-dir", default="results")
    parser.add_argument("--start-time", default=None)
    parser.add_argument("--metric", default="test_auc",
                        help="meter prefix to plot (e.g. loss, test_auc)")
    parser.add_argument("-o", "--output", default=None)
    args = parser.parse_args(argv)
    runs = load_meters(args.results_dir, args.start_time)
    out = args.output or os.path.join(
        args.results_dir, "visualize_{}.png".format(args.metric))
    print("saved", plot_meters(runs, args.metric, out))


if __name__ == "__main__":
    main()
