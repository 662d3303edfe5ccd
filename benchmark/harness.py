"""One run of one cell: set-up, the measured window, the check, the
result line.

Everything a cell needs is found by name: its entry in
``BENCHMARK.json`` (config, traffic), ``workloads/<cell>.json`` (the
driver, the check's steps and limits, the traced stretch),
``configs/<config>.json`` (the program's flags), ``traffic/<traffic>.json``
(the cohort), ``drivers/<driver>.py``, the network's plain reference
``reference/networks/<flags.network>.py`` and, for each metric the cell
reports, ``metrics/<metric, up to its first dot>.py``, whose ``read(run)``
returns the value or None when it finds nothing to read.
"""
import gc
import importlib
import json
import os
import sys
import time

import numpy as np
import torch

from benchmark import checks, cohort, program
from benchmark.reference import flops as flops_lib
from benchmark.trace import StepClock
from benchmark.weights import make_weights

BENCH_DIR = os.path.dirname(os.path.abspath(__file__))
FORBIDDEN = ("jax", "jaxlib", "flax", "deepards_tpu")


def read_json(*parts):
    with open(os.path.join(*parts)) as f:
        return json.load(f)


def load_cell(name, bench_dir=BENCH_DIR, manifest=None):
    """(manifest entry, cell file, config file, traffic file) of cell
    ``name``."""
    if manifest is None:
        manifest = read_json(os.path.dirname(bench_dir), "BENCHMARK.json")
    entry = {w["name"]: w for w in manifest["workloads"]}[name]
    cell = read_json(bench_dir, "workloads", name + ".json")
    config = read_json(bench_dir, "configs", entry["config"] + ".json")
    traffic = read_json(bench_dir, "traffic", entry["traffic"] + ".json")
    return entry, cell, config, traffic


def metrics_of(manifest, name, traced):
    """The metrics cell ``name`` reports: its per-layer ones when traced,
    else its end-to-end ones."""
    group = manifest["per_layer" if traced else "end_to_end"]
    return [m for m in group if name in m.get("workloads", [name])]


def reader(metric_name):
    return importlib.import_module(
        "benchmark.metrics." + metric_name.split(".")[0]).read


def seeds(seed):
    """The run's sub-seeds, each drawn from ``seed`` (any whole number)."""
    state = np.random.SeedSequence(int(seed) % (1 << 64)).generate_state(5)
    names = ("data", "weights", "dropout", "check", "program")
    return {k: int(v) + 1 for k, v in zip(names, state)}


def forbidden_modules():
    return sorted({m.split(".")[0] for m in sys.modules} & set(FORBIDDEN))


def peak_table(bench_dir=BENCH_DIR):
    return read_json(bench_dir, "peaks.json")


class Run:
    """What a run knows: its cell, inputs, clock and counters."""

    def __init__(self, name, seed, seconds, traced, device, started,
                 bench_dir=BENCH_DIR, manifest=None):
        self.name = name
        self.seconds = seconds
        self.traced = traced
        self.device = torch.device(device)
        self.started = started
        self.bench_dir = bench_dir
        self.manifest = manifest or read_json(os.path.dirname(bench_dir),
                                              "BENCHMARK.json")
        self.entry, self.cell, self.config, self.traffic = load_cell(
            name, bench_dir, self.manifest)
        self.seeds = seeds(seed)
        self.conf = program.configuration(self.config,
                                          self.seeds["program"])
        self.n_sub_batches = self.conf.n_sub_batches
        self.patient_of_row, self.class_of_row, _ = cohort.rows(self.traffic)
        self.clock = StepClock(device=self.device)
        self.counters = {"epoch_kind": self.traffic["epoch"]}
        self.trace = None
        self.stages = {}
        self._mark = started

    def mark(self, stage):
        """Record the host seconds since the last mark as ``stage``'s, for
        the set-up's breakdown."""
        self.sync()
        now = time.perf_counter()
        self.stages[stage] = now - self._mark
        self._mark = now

    def make_inputs(self):
        """The cohort's windows (on the host, drawn on the device) and the
        initial weights (on the device), from the seed."""
        shape = (self.n_sub_batches, 1, cohort.WINDOW)
        self.data = cohort.make_windows(len(self.class_of_row), shape,
                                        self.seeds["data"], self.device)
        self.weights = make_weights(self.config["flags"]["network"],
                                    self.n_sub_batches,
                                    self.seeds["weights"], self.device)

    def sync(self):
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)


def measure(run, driver):
    """Set-up, then whole epochs until ``run.seconds`` have passed, then
    the deferred records; fills ``run.counters``.  The steps and the real
    windows are counted as the runner's calls and the sum of the masks
    the trainer gave them."""
    clock = run.clock
    run.mark("start")
    run.make_inputs()
    run.mark("inputs")
    driver.setup()
    run.sync()
    window_start = time.perf_counter()
    run.counters["setup_s"] = window_start - run.started
    calls0 = clock.calls
    clock.reset_rows()
    driver.hooks(clock, calls0)
    if run.traced:
        stretch = run.cell["trace"]
        clock.stretch = (calls0 + stretch["start_step"], stretch["steps"])
    epochs = 0
    epoch_s = []
    overhead0 = clock.overhead
    preambles0 = len(clock.preambles)
    with driver.fetch_scope():
        while True:
            t0 = time.perf_counter()
            clock.epoch_started()
            with clock.span("trainer.epoch"):
                driver.epoch(epochs + 1)
            epoch_s.append(time.perf_counter() - t0)
            epochs += 1
            if time.perf_counter() - window_start >= run.seconds:
                break
        run.sync()
        flush_start = time.perf_counter()
    run.sync()
    window_end = time.perf_counter()
    clock.close()
    losses = np.asarray(driver.losses(), np.float64)
    # the profiler's start and stop are the trace's, not the program's
    overhead = clock.overhead - overhead0
    run.counters.update(
        window_s=window_end - window_start - overhead,
        windows=clock.rows(), steps=clock.calls - calls0, epochs=epochs,
        epoch_s=epoch_s, recorded_losses=len(losses),
        preamble_s=clock.preambles[preambles0:],
        flush_s=window_end - flush_start,
        failed_steps=int((~np.isfinite(losses)).sum()),
        memory_peak_bytes=(torch.cuda.max_memory_allocated(run.device)
                           if run.device.type == "cuda" else 0))
    run.trace = clock.device_trace()


def run_cell(name, seed, seconds, traced, device="cuda", started=None,
             bench_dir=BENCH_DIR, manifest=None):
    """One run; returns (result dict, [(check, value, limit)])."""
    started = time.perf_counter() if started is None else started
    run = Run(name, seed, seconds, traced, device, started, bench_dir,
              manifest)
    driver = importlib.import_module(
        "benchmark.drivers." + run.cell["driver"]).Driver(run)
    measure(run, driver)
    answers = driver.answers()
    driver.free()
    gc.collect()
    if run.device.type == "cuda":
        torch.cuda.empty_cache()
    numbers = driver.numbers(answers, driver.reference())
    numbers.update(checks.count_numbers(
        run.counters, driver.expected(run.counters["epochs"])))
    limits = run.cell["check"]["limits"]
    checked = [(k, float(numbers[k]), float(limits[k])) for k in limits]
    correct = (all(v <= lim for _, v, lim in checked)
               and run.counters["failed_steps"] == 0)
    out = result(run, correct)
    out["readings"] = numbers
    return out, checked


def result(run, correct):
    """The result line's fields: the cell's metrics, each read by its
    reader, the device, and with a trace its busy time and breakdown."""
    counters = run.counters
    if run.traced:
        flags = run.config["flags"]
        counters["flops_per_window"] = flops_lib.flops_per_window(
            flags["network"], run.n_sub_batches,
            counters["epoch_kind"] == "train")
    device = {"platform": "gpu" if run.device.type == "cuda" else "cpu",
              "kind": (torch.cuda.get_device_name(run.device)
                       if run.device.type == "cuda" else "cpu"),
              "count": 1,
              "memory_peak_bytes": counters["memory_peak_bytes"]}
    run.peak = peak_table(run.bench_dir).get(device["kind"])
    metrics = {}
    for m in metrics_of(run.manifest, run.name, run.traced):
        value = reader(m["name"])(run)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    out = {"correct": bool(correct), "attempted": counters["steps"],
           "failed": counters["failed_steps"], "metrics": metrics,
           "device": device, "stages": run.stages,
           "timing": {"epoch_s": counters["epoch_s"],
                      "preamble_s": counters["preamble_s"],
                      "flush_s": counters["flush_s"]}}
    if run.traced and run.trace is not None:
        device["busy_s"] = run.trace.busy_us * 1e-6
        device["window_s"] = run.trace.window_us * 1e-6
        out["breakdown"] = {"device_ops": run.trace.top_kernels(),
                            "idle_gaps": run.trace.idle_gaps()}
    return out


def report(out, checked):
    """The checks on standard error, last; the result line on standard
    output, last, with the checks under a key of their own, last."""
    out["checks"] = {k: {"value": v, "limit": lim} for k, v, lim in checked}
    print("set-up stages (s): " + json.dumps(out.pop("stages", {})),
          file=sys.stderr)
    print("window (s): " + json.dumps(out.pop("timing", {})),
          file=sys.stderr)
    print("readings: " + json.dumps(out.pop("readings", {})),
          file=sys.stderr)
    for k, v, lim in checked:
        print("check {} {} limit {}".format(k, v, lim), file=sys.stderr)
    print(json.dumps(out), flush=True)
