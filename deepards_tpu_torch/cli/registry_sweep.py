"""Health-sweep every generated experiment yml through a debug epoch and
an eval, recording a machine-readable artifact.

Counterpart of ``deepards_tpu/cli/registry_sweep.py``: each config of the
registry trains one debug epoch and evaluates one fold end to end through
the port's ``cli.train.main``, as a user would run it, with the JAX
sweep's flags (``-b 4 --n-sub-batches 4 --compute-dtype float32``, 2
folds and ``--only-fold 0`` unless the config is a holdout without
``kfolds``, the
170-patient wide cohort for ``train_pt_frac`` < 0.5) and ``--device``.
The registry is written by ``config.generate_experiments`` into the
sweep's directory (the cohort's parent), and the cohort holds every
holdout layout the registry names (the JAX sweep's lacks the similarity
splits' and ``80_20_random``'s, whose configs fail there for want of
their directories).  Output is a JSON map
``{config: {"ok": bool, "wall_s": float, "error": str|null, "backend":
str}}`` written after each config, so an interrupted sweep resumes where
it left off.

Usage:
    python -m deepards_tpu_torch.cli.registry_sweep --out SWEEP.json \\
        [--cohort DIR] [--only NAME ...] [--start N] [--stop N] \\
        [--device cuda]
"""
import argparse
import gc
import json
import os
import shutil
import tempfile
import time
import traceback

#: the JAX sweep's holdout layouts; all are symlinks to all_data in the
#: synthetic cohort (same patients, the split protocol itself is what's
#: under test here)
SUBDIRS = ("all_data", "aim1_70_30_training", "aim1_70_30_testing",
           "randomtrain", "randomval", "randomtest")


def holdout_layouts(registry):
    """``SUBDIRS`` and the train, val and test directories of every other
    ``holdout_set_type`` the registry names (the similarity splits,
    ``80_20_random``), which the JAX sweep's cohort lacks."""
    from deepards_tpu_torch.config import yamlfile

    layouts = list(SUBDIRS)
    for name in sorted(os.listdir(registry)):
        kind = yamlfile.read(os.path.join(registry, name)).get(
            "holdout_set_type")
        if kind and kind not in ("main", "random"):
            layouts += [kind + end for end in ("train", "val", "test")
                        if kind + end not in layouts]
    return layouts


def ensure_cohort(path, n_patients=8, n_breaths=260, subdirs=SUBDIRS):
    """The sweep's synthetic cohort at ``path`` (generated once; a
    layout of ``subdirs`` it lacks is linked to all_data); returns its
    cohort CSV."""
    from deepards_tpu_torch.data.synthetic import generate_cohort

    csv = os.path.join(path, "cohort-description.csv")
    if not os.path.exists(csv):
        os.makedirs(path, exist_ok=True)
        generate_cohort(path, n_patients=n_patients,
                        n_breaths_per_patient=n_breaths, seed=7,
                        subdirs=subdirs)
        return csv
    exp = os.path.join(path, "experiment1")
    for sub in subdirs[1:]:
        for kind in ("raw", "meta"):
            dst = os.path.join(exp, sub, kind)
            if not os.path.exists(dst):
                os.makedirs(os.path.dirname(dst), exist_ok=True)
                os.symlink(os.path.abspath(
                    os.path.join(exp, "all_data", kind)), dst)
    return csv


def ensure_registry(sweep_dir):
    """The generated registry, written into ``sweep_dir/registry``."""
    from deepards_tpu_torch.config.generate_experiments import write_all

    registry = os.path.join(sweep_dir, "registry")
    write_all(registry)
    return registry


def sweep_argv(path, cohort, csv, results_dir, device):
    """``cli.train``'s argv for one config: one debug epoch and its eval."""
    from deepards_tpu_torch.config import yamlfile

    cfg = yamlfile.read(path)
    argv = [
        "-co", path,
        "--data-path", cohort, "--cohort-file", csv,
        "--epochs", "1", "--debug",
        "-b", "4", "--n-sub-batches", "4",
        "--compute-dtype", "float32", "--results-dir", results_dir,
        "--seed", "5", "--device", device,
    ]
    # holdout-protocol configs (e.g. drop_if_under_r2 heterogeneity
    # filters) reject kfold mode by design: run them under their own
    # split protocol instead of forcing the sweep's 2-fold override.  A
    # config that names both a holdout and kfolds trains k-fold, and
    # gets the 2 folds too (the JAX sweep keeps its 5, which the 8-patient
    # cohort cannot stratify)
    if cfg.get("kfolds") or not (cfg.get("holdout_set_type")
                                 or cfg.get("drop_if_under_r2")):
        argv += ["--kfolds", "2", "--only-fold", "0"]
    if cfg.get("train_pt_frac") and float(cfg["train_pt_frac"]) < 0.5:
        # small fractions need a wide cohort: after the 2-fold split
        # halves the patient pool, floor(n_train*frac)//2 must stay >= 1,
        # so frac=0.025 needs >= 80 train patients -> 170 total
        wide = os.path.join(os.path.dirname(cohort), "regsweep_wide")
        csv_wide = ensure_cohort(wide, n_patients=170, n_breaths=40)
        argv[argv.index("--data-path") + 1] = wide
        argv[argv.index("--cohort-file") + 1] = csv_wide
    return argv


def run_one(path, cohort, csv, device):
    """One debug-epoch train and eval of the yml at ``path`` through the
    CLI.  Returns the error, or None."""
    from deepards_tpu_torch.cli.train import main as train_main

    results_dir = tempfile.mkdtemp(prefix="regsweep_",
                                   dir=os.path.dirname(cohort))
    try:
        train_main(sweep_argv(path, cohort, csv, results_dir, device))
    except SystemExit as e:
        if e.code not in (0, None):
            return "SystemExit %s" % e.code
    except Exception as e:  # noqa: BLE001 - the sweep survives any config
        traceback.print_exc()
        return "%s: %s" % (type(e).__name__, str(e)[:300])
    finally:
        shutil.rmtree(results_dir, ignore_errors=True)
    return None


def clear_caches(device):
    gc.collect()
    if device.startswith("cuda"):
        import torch

        torch.cuda.empty_cache()


def main(argv=None):
    p = argparse.ArgumentParser(prog="deepards-registry-sweep-torch")
    p.add_argument("--out", required=True)
    p.add_argument("--cohort", default=os.path.join(
        tempfile.gettempdir(), "regsweep", "cohort"))
    p.add_argument("--only", nargs="*")
    p.add_argument("--start", type=int, default=0)
    p.add_argument("--stop", type=int, default=None)
    p.add_argument("--device", default="cuda",
                   help="torch device of the runs (default: cuda; raises "
                   "when no card is present)")
    p.add_argument("--clear-caches-every", type=int, default=8,
                   help="empty the CUDA caching allocator every N configs "
                   "to bound device memory over a long sweep")
    args = p.parse_args(argv)

    from deepards_tpu_torch.device import resolve_device

    backend = resolve_device(args.device).type
    registry = ensure_registry(os.path.dirname(os.path.abspath(args.cohort)))
    csv = ensure_cohort(args.cohort, subdirs=holdout_layouts(registry))
    configs = sorted(f for f in os.listdir(registry) if f.endswith(".yml"))
    if args.only:
        configs = [c for c in configs if c in set(args.only)]
    configs = configs[args.start: args.stop]

    results = {}
    if os.path.exists(args.out):
        with open(args.out) as f:
            results = json.load(f)

    for i, name in enumerate(configs):
        if results.get(name, {}).get("ok"):
            continue  # resumable: skip configs already clean
        t0 = time.perf_counter()
        err = run_one(os.path.join(registry, name), args.cohort, csv,
                      args.device)
        wall = round(time.perf_counter() - t0, 1)
        results[name] = {"ok": err is None, "wall_s": wall,
                         "error": err, "backend": backend}
        tag = "OK  " if err is None else "FAIL"
        print("%s %6.1fs [%d/%d] %s %s" % (
            tag, wall, i + 1, len(configs), name, err or ""), flush=True)
        tmp = args.out + ".tmp"
        with open(tmp, "w") as f:
            json.dump(results, f, indent=1, sort_keys=True)
        os.replace(tmp, args.out)
        if args.clear_caches_every and (i + 1) % args.clear_caches_every == 0:
            clear_caches(args.device)

    n_ok = sum(1 for r in results.values() if r["ok"])
    print("SWEEP SUMMARY: %d ok / %d recorded" % (n_ok, len(results)),
          flush=True)
    return results


if __name__ == "__main__":
    main()
