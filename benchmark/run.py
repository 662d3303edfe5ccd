"""Run one cell of the benchmark of deepards_tpu_torch on the card.

    python3 benchmark/run.py --workload NAME --seed N --seconds S --trace 0|1

prints the run's checks as the last lines of standard error and its
result as one JSON line, the last of standard output.  Exits non-zero,
with no result, when no card is present, when the program is missing,
when the check cannot run, or when JAX or the JAX package is loaded once
the window has closed.
"""
import time

STARTED = time.perf_counter()

import argparse  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CACHE = os.path.join(ROOT, "benchmark", ".cache")


def parse(argv):
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seed", type=int, required=True)
    parser.add_argument("--seconds", type=float, required=True)
    parser.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return parser.parse_args(argv)


def main(argv=None):
    args = parse(argv)
    # the program's kernel caches at fixed places inside the checkout
    os.environ["TRITON_CACHE_DIR"] = os.path.join(CACHE, "triton")
    os.environ["TORCH_EXTENSIONS_DIR"] = os.path.join(CACHE,
                                                      "torch_extensions")
    os.environ["USE_FLAX"] = "0"
    import json

    import torch

    with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
        chips = {w["name"]: w["chips"]
                 for w in json.load(f)["workloads"]}[args.workload]
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print("the cell needs {} CUDA device(s): the benchmark measures "
              "the card".format(chips), file=sys.stderr)
        return 2
    sys.path.insert(0, ROOT)
    from benchmark import harness

    out, checked = harness.run_cell(args.workload, args.seed, args.seconds,
                                    bool(args.trace), "cuda", STARTED)
    loaded = harness.forbidden_modules()
    if loaded:
        print("loaded in the measured process: {}".format(", ".join(loaded)),
              file=sys.stderr)
        return 3
    harness.report(out, checked)
    return 0


if __name__ == "__main__":
    sys.exit(main())
