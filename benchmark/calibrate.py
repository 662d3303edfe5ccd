"""The readings that the check's limits are set from, on the card.

    python3 benchmark/calibrate.py --workload NAME --seeds N [N ...]
        [--control-seeds N [N ...]]

For each seed of ``--seeds`` one line ``{"kind": "program", ...}``: the
numbers of a sound run of the program at the cell's own size (set-up and
one epoch, its records flushed, the check following that epoch as it
follows a run's first).  For each seed of ``--control-seeds`` also the numbers
of the reference put in the program's place:

- ``control``: computed in float8 e4m3, the precision below the
  configuration's bfloat16;
- ``bfloat16``: rounded to bfloat16 where the program rounds, a witness
  of what the configuration's own precision reads;
- ``half``: half of each batch (or of a patient's windows) left out, the
  loss's mean taken over the rest;
- ``altered`` (a test cell): the program's predictions of the first
  step's windows flipped where they are produced.

A state left unchanged reads 1 on a train cell's ``change_gap`` by its
definition and needs no run.  Every seed runs in this one process.
"""
import argparse
import gc
import json
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def altered(answers, rows):
    """The program's answers with the predictions of ``rows`` flipped."""
    out = dict(answers, preds=dict(answers["preds"]))
    for row in rows:
        out["preds"][row] = 1 - out["preds"][row]
    return out


def readings(workload, seed, program=True, controls=False, device="cuda",
             bench_dir=None, manifest=None):
    """[(kind, numbers)] of one seed: the program's, and the controls'."""
    import importlib

    import torch

    from benchmark import checks, harness
    from benchmark.reference.precision import bf16, fp8_e4m3

    t0 = time.perf_counter()
    run = harness.Run(workload, seed, 0.0, False, device, t0,
                      bench_dir or harness.BENCH_DIR, manifest)
    driver = importlib.import_module(
        "benchmark.drivers." + run.cell["driver"]).Driver(run)
    harness.measure(run, driver)
    answers = driver.answers()
    driver.free()
    gc.collect()
    if run.device.type == "cuda":
        torch.cuda.empty_cache()
    ref = driver.reference()
    out = []
    if program:
        numbers = driver.numbers(answers, ref)
        numbers.update(checks.count_numbers(
            run.counters, driver.expected(run.counters["epochs"])))
        out.append(("program", numbers))
    if controls:
        for kind, kw in (("control", {"quant": fp8_e4m3}),
                         ("bfloat16", {"quant": bf16}),
                         ("half", {"leave_out_half": True})):
            other = driver.as_answers(driver.reference(**kw))
            out.append((kind, driver.numbers(other, ref)))
        if run.traffic["epoch"] == "test":
            out.append(("altered", driver.numbers(
                altered(answers, driver.first_step_rows()), ref)))
    return out


def main(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seeds", type=int, nargs="+", required=True)
    parser.add_argument("--control-seeds", type=int, nargs="*", default=())
    args = parser.parse_args(argv)
    sys.path.insert(0, ROOT)
    import torch

    for seed in list(args.seeds) + [s for s in args.control_seeds
                                     if s not in args.seeds]:
        t0 = time.perf_counter()
        for kind, numbers in readings(args.workload, seed,
                                      seed in args.seeds,
                                      seed in args.control_seeds):
            print(json.dumps({"kind": kind, "workload": args.workload,
                              "seed": seed, "numbers": numbers,
                              "seconds": time.perf_counter() - t0}),
                  flush=True)
        gc.collect()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()


if __name__ == "__main__":
    main()
