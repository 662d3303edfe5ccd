"""Experiments recorded in a results directory.

Counterpart of ``deepards_tpu/cli/find_all_experiments.py`` (reference:
deepards/find_all_experiments.py):

  python -m deepards_tpu_torch.cli.find_all_experiments \\
      [--results-dir results]

It reads the hyperparameter files the port's trainer writes,
``{name}_{uuid}.json`` (``eval.metrics.DeepARDSResults.save_all``), and
gives each one's file, experiment name, network and start time.
"""
import argparse
import glob
import json
import os


def find_experiments(results_dir="results"):
    """One dict a hyperparameter file, sorted by file name: file,
    experiment, network, start_time.  Results, patient, aggregate and
    maximal tables and unreadable files are skipped."""
    out = []
    for path in sorted(glob.glob(os.path.join(results_dir, "*_*.json"))):
        base = os.path.basename(path)
        if base.endswith(("_patient_results.json", "_aggregate_results.json",
                          "_maximal_results.json")) or "_results_" in base:
            continue
        try:
            with open(path) as f:
                hp = json.load(f)
        except (OSError, ValueError):
            continue
        if isinstance(hp, dict):
            conf = hp.get("conf") or {}
            out.append({"file": base,
                        "experiment": conf.get("experiment_name"),
                        "network": conf.get("network"),
                        "start_time": hp.get("start_time")})
    return out


def main(argv=None):
    parser = argparse.ArgumentParser(prog="deepards-find-experiments-torch")
    parser.add_argument("--results-dir", default="results")
    args = parser.parse_args(argv)
    rows = find_experiments(args.results_dir)
    for row in rows:
        print(row)
    return rows


if __name__ == "__main__":
    main()
