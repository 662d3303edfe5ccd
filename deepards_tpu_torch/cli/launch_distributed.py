"""Multi-process training launcher.

Counterpart of ``deepards_tpu/cli/launch_distributed.py``: spawns N
ranks of ``deepards_tpu_torch.cli.train`` that join one
``torch.distributed`` group over gloo (rank 0 listens at
``--coordinator``, by default a free port of this host), so one run's batches are sharded over the ranks
(``dp_devices`` -1 or N: the norms' statistics, the loss and the
gradient span every rank's rows, and every rank gathers every eval
prediction).  Every rank writes the same results, each under
``<results_dir>/rank<i>``; rank 0 writes the checkpoints.  On one card
the ranks share it (device index 0).

Usage:
  python -m deepards_tpu_torch.cli.launch_distributed -n 2 -- \\
      --data-path ... --cohort-file ... -n cnn_linear ... [--device cpu]

Everything after ``--`` goes to each rank's ``cli.train`` as it is.
"""
import argparse
import os
import socket
import subprocess
import sys
import time


def build_parser():
    parser = argparse.ArgumentParser(description=__doc__)
    parser.add_argument("-n", "--num-processes", type=int, default=2)
    parser.add_argument("--coordinator",
                        help="host:port of rank 0 (default: a free port "
                        "of 127.0.0.1)")
    parser.add_argument("--device",
                        help="each rank's torch device (default: the card; "
                        "the ranks share it)")
    parser.add_argument("--results-dir", default="results")
    parser.add_argument("train_args", nargs=argparse.REMAINDER,
                        help="arguments after -- go to cli.train")
    return parser


def free_coordinator():
    """127.0.0.1 and a port that no process holds now."""
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return "127.0.0.1:{}".format(s.getsockname()[1])


def rank_command(args, rank, train_args):
    """The argv of rank ``rank``'s ``cli.train``."""
    cmd = [
        sys.executable, "-m", "deepards_tpu_torch.cli.train",
        "--distributed-coordinator", args.coordinator,
        "--num-processes", str(args.num_processes),
        "--process-id", str(rank),
        "--results-dir", os.path.join(args.results_dir,
                                      "rank{}".format(rank)),
    ]
    if args.device:
        cmd += ["--device", args.device]
    return cmd + train_args


def main(argv=None):
    args = build_parser().parse_args(argv)
    train_args = list(args.train_args)
    if train_args and train_args[0] == "--":
        train_args = train_args[1:]
    if args.coordinator is None:
        args.coordinator = free_coordinator()
    procs = []
    try:
        for rank in range(args.num_processes):
            os.makedirs(os.path.join(args.results_dir,
                                     "rank{}".format(rank)), exist_ok=True)
            procs.append(subprocess.Popen(
                rank_command(args, rank, train_args)))
        # until every rank ends, or one fails (the others would wait on
        # it in their next collective)
        rcs = [None] * len(procs)
        while None in rcs and not any(rcs):
            time.sleep(0.1)
            rcs = [p.poll() for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
            p.wait()
    rcs = [p.returncode for p in procs]
    if any(rcs):
        raise SystemExit("distributed ranks failed: {}".format(rcs))
    print("all {} ranks completed".format(args.num_processes))


if __name__ == "__main__":
    main()
