"""A copy of the benchmark's files cut to a size the CPU runs in seconds:
S breaths a window, a batch of a few samples, patients of a few tens of
windows, a traced stretch of two steps.  The widths of the networks stay
as they are."""
import json
import os
import shutil
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

import torch  # noqa: E402

from benchmark import harness  # noqa: E402

torch.set_num_threads(2)


def _edit(path, fn):
    with open(path) as f:
        data = json.load(f)
    fn(data)
    with open(path, "w") as f:
        json.dump(data, f)


def tiny_bench(dst, breaths=2, batch=5, windows=(17, 30),
               compute_dtype="float32"):
    """(benchmark directory, manifest) of a cut copy under ``dst``."""
    bench = os.path.join(str(dst), "benchmark")
    shutil.copytree(harness.BENCH_DIR, bench,
                    ignore=shutil.ignore_patterns("__pycache__", ".cache"))

    def config(d):
        d["flags"]["n_sub_batches"] = breaths
        d["flags"]["compute_dtype"] = compute_dtype
        if d["flags"]["batch_size"] > 1:
            d["flags"]["batch_size"] = batch

    def traffic(d):
        d["windows"] = list(windows)

    def workload(d):
        d["trace"] = {"start_step": 1, "steps": 2}

    for sub, fn in (("configs", config), ("traffic", traffic),
                    ("workloads", workload)):
        for name in os.listdir(os.path.join(bench, sub)):
            _edit(os.path.join(bench, sub, name), fn)
    shutil.copy(os.path.join(ROOT, "BENCHMARK.json"), str(dst))
    return bench, harness.read_json(str(dst), "BENCHMARK.json")


def run(bench, manifest, cell, seed=2 ** 31 + 11, seconds=0.5,
        traced=False):
    return harness.run_cell(cell, seed, seconds, traced, "cpu",
                            bench_dir=bench, manifest=manifest)
