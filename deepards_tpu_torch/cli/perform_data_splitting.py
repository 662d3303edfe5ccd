"""Create holdout splits by symlinking patient dirs.

Counterpart of ``deepards_tpu/cli/perform_data_splitting.py`` (reference:
deepards/perform_data_splitting.py:125-239) on the standard library: the
cohort CSV is read with ``csv`` and a preset split file through
``config.splitfile``.  Random splits (with validation sets) and preset
splits make ``experiment<N>/<name>{train,val,test}/{raw,meta}/<patient>``
links into ``all_data``, the layout ``ARDSRawDataset`` reads for a holdout
set type.  Patient ids are kept as the CSV spells them.  Run: ``python -m
deepards_tpu_torch.cli.perform_data_splitting -dp <data path> -c <cohort
csv> {random,preset_file} [-f <split file>]``.
"""
import argparse
import csv
import math
import os
import shutil

import numpy as np

from deepards_tpu_torch.config import splitfile


class Splitting:
    def __init__(self, dataset_path, cohort_file, experiment_num=1,
                 seed=None):
        self.dataset_path = dataset_path
        self.experiment_dir = os.path.join(
            dataset_path, "experiment{}".format(experiment_num))
        self.all_data_raw_dir = os.path.join(
            self.experiment_dir, "all_data", "raw")
        self.all_data_meta_dir = os.path.join(
            self.experiment_dir, "all_data", "meta")
        self.rng = np.random.default_rng(seed)
        # every row in file order, as the JAX package lists them
        with open(cohort_file, newline="") as f:
            rows = list(csv.DictReader(f))
        self.ards_pts = [r["Patient Unique Identifier"] for r in rows
                         if r["Pathophysiology"] == "ARDS"]
        self.other_pts = [r["Patient Unique Identifier"] for r in rows
                          if r["Pathophysiology"] != "ARDS"]

    def perform_preset_file_split(self, file_path):
        """Split from a split file's train:/test: patient lists."""
        conf = splitfile.read(file_path)
        split_name = os.path.splitext(os.path.basename(file_path))[0]
        self.create_split([str(p) for p in conf["train"]],
                          split_name + "train")
        self.create_split([str(p) for p in conf["test"]],
                          split_name + "test")

    def perform_random_split(self, split_ratio=1 / 6.0,
                             validation_ratio=1 / 6.0, out_dir_prefix=None,
                             n_train=None, n_val=None, n_test=None):
        all_pts = self.ards_pts + self.other_pts
        if not n_train or n_val is None or not n_test:
            n_test = int(len(all_pts) * split_ratio)
            n_val = int(math.ceil(n_test * validation_ratio))
            n_train = len(all_pts) - n_test
        other_test = list(
            self.rng.choice(self.other_pts, size=n_test // 2, replace=False))
        ards_test = list(
            self.rng.choice(self.ards_pts, size=n_test // 2, replace=False))
        test_pts = other_test + ards_test
        train_pool = sorted(set(all_pts) - set(test_pts))
        train_pts = list(
            self.rng.choice(train_pool, size=min(n_train, len(train_pool)),
                            replace=False))
        prefix = out_dir_prefix or "random"
        self.create_split(train_pts, "{}train".format(prefix))
        if n_val > 0:
            remaining = set(all_pts) - set(test_pts) - set(train_pts)
            rem_other = sorted(set(self.other_pts) & remaining)
            rem_ards = sorted(set(self.ards_pts) & remaining)
            val_pts = list(
                self.rng.choice(rem_ards,
                                size=min(n_val // 2, len(rem_ards)),
                                replace=False)
            ) + list(
                self.rng.choice(rem_other,
                                size=min(n_val // 2, len(rem_other)),
                                replace=False)
            )
            self.create_split(val_pts, "{}val".format(prefix))
        self.create_split(test_pts, "{}test".format(prefix))
        return train_pts, test_pts

    def create_split(self, pts, main_dirname):
        out = os.path.join(self.experiment_dir, main_dirname)
        shutil.rmtree(out, ignore_errors=True)
        os.makedirs(os.path.join(out, "raw"))
        os.makedirs(os.path.join(out, "meta"))
        for pt in pts:
            for kind, src_dir in (("raw", self.all_data_raw_dir),
                                  ("meta", self.all_data_meta_dir)):
                src = os.path.join(src_dir, str(pt))
                if os.path.exists(src):
                    os.symlink(src, os.path.join(out, kind, str(pt)))


def main(argv=None):
    parser = argparse.ArgumentParser(prog="deepards-split-data-torch")
    parser.add_argument("-dp", "--dataset-path", required=True)
    parser.add_argument("-c", "--cohort-file", required=True)
    parser.add_argument("set_type", choices=["random", "preset_file"])
    parser.add_argument("-sr", "--split-ratio", type=float, default=1 / 6.0)
    parser.add_argument("-vr", "--validation-ratio", type=float,
                        default=1 / 6.0)
    parser.add_argument("-o", "--out-dir")
    parser.add_argument("-f", "--preset-file")
    parser.add_argument("-ntr", "--n-train", type=int)
    parser.add_argument("-nv", "--n-val", type=int)
    parser.add_argument("-nt", "--n-test", type=int)
    parser.add_argument("--seed", type=int)
    args = parser.parse_args(argv)

    splitter = Splitting(args.dataset_path, args.cohort_file, seed=args.seed)
    if args.set_type == "random":
        splitter.perform_random_split(
            args.split_ratio, args.validation_ratio, args.out_dir,
            args.n_train, args.n_val, args.n_test,
        )
    elif args.preset_file is None:
        raise SystemExit("preset_file split requires --preset-file")
    else:
        splitter.perform_preset_file_split(args.preset_file)


if __name__ == "__main__":
    main()
