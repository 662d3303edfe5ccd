"""Experiment launcher: queue N repeat runs of experiment files,
optionally sweeping a parameter grid.

Counterpart of ``deepards_tpu/cli/run_experiments.py`` (reference:
deepards/scripts/main/run_non_pretraining_experiments.py:17-39, which
queued runs through the `ts` task spooler and split them across GPUs via
--cuda-devices 0+1; and the shell grids under scripts/exploratory/ and
scripts/main/).  ``--grid`` sweeps CLI flags declaratively:

  python -m deepards_tpu_torch.cli.run_experiments exp.yml -n 1 \\
      --grid base-network=resnet18,senet18,densenet18 batch-size=16,32,64

Each run is ``python -m deepards_tpu_torch.cli.train -co exp.yml --seed
RUN -exp NAME[-V...]-runRUN`` plus the grid point's flags and
``--extra-args``; runs execute one after another.  ``--device-assignment
0+1`` gives the runs, round-robin, a ``CUDA_VISIBLE_DEVICES`` each.
"""
import argparse
import itertools
import os
import subprocess
import sys


def queue_runs(experiment_files, n_runs, devices, grid):
    """(experiment file, run, device or None, grid point) of every run, in
    launch order; a grid point is ((flag, value), ...)."""
    axes = []
    for spec in grid:
        flag, _, values = spec.partition("=")
        axes.append([("--" + flag.lstrip("-"), v) for v in values.split(",")])
    points = list(itertools.product(*axes)) if axes else [()]
    queue = []
    for exp in experiment_files:
        for point in points:
            for run in range(n_runs):
                queue.append((exp, run, devices[len(queue) % len(devices)],
                              point))
    return queue


def run_command(exp, run, point, extra_args):
    """The training command of one queued run."""
    tag = "".join("-{}".format(v) for _, v in point)
    cmd = [
        sys.executable, "-m", "deepards_tpu_torch.cli.train",
        "-co", exp, "--seed", str(run),
        "-exp", "{}{}-run{}".format(
            os.path.splitext(os.path.basename(exp))[0], tag, run),
    ]
    for flag, v in point:
        cmd.extend([flag, v])
    return cmd + list(extra_args)


def main(argv=None):
    parser = argparse.ArgumentParser(prog="deepards-run-experiments-torch")
    parser.add_argument("experiment_files", nargs="+")
    parser.add_argument("-n", "--n-runs", type=int, default=10)
    parser.add_argument("--device-assignment", default=None,
                        help="e.g. '0+1': round-robin runs across these "
                        "CUDA devices (CUDA_VISIBLE_DEVICES)")
    parser.add_argument("--dry-run", action="store_true")
    parser.add_argument("--grid", nargs="*", default=[],
                        metavar="FLAG=V1,V2",
                        help="cartesian sweep of CLI flags, e.g. "
                        "base-network=resnet18,densenet18 batch-size=16,32")
    parser.add_argument("--extra-args", nargs=argparse.REMAINDER,
                        default=[])
    args = parser.parse_args(argv)

    devices = (args.device_assignment.split("+") if args.device_assignment
               else [None])
    launched = []
    for exp, run, dev, point in queue_runs(args.experiment_files,
                                           args.n_runs, devices, args.grid):
        cmd = run_command(exp, run, point, args.extra_args)
        env = dict(os.environ)
        if dev is not None:
            env["CUDA_VISIBLE_DEVICES"] = dev
        print("run:", " ".join(cmd), "(device {})".format(dev))
        if not args.dry_run:
            subprocess.run(cmd, check=False, env=env)
        launched.append((cmd, dev))
    return launched


if __name__ == "__main__":
    main()
