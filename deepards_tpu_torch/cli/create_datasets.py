"""Pretraining-corpus builders and split helpers.

Counterpart of ``deepards_tpu/cli/create_datasets.py`` on numpy and the
standard library (the cohort CSV through ``csv``; no pandas), with the
reference's dataset-prep scripts
(reference: deepards/create_separate_breath_meta_dataset.py:16-152,
create_breath_meta_dataset_split.py:9-63,
create_autoencoder_dataset.py, create_contiguous_vwd_dataset.py):

- ``build-bm-corpus``: per-patient KMeans over breath-meta features,
  sample ``breaths_per_clust`` per cluster, re-emit processed files —
  a diverse-breath pretraining corpus.
- ``split-pretraining``: symlink train(=non-cohort) / test(=cohort)
  patient dirs for the regression pretraining task.
- ``build-contiguous``: re-emit the first N contiguous breaths per
  patient (autoencoder / contiguous-vwd corpora).

Files are written through ``data/reader.py`` as the JAX package writes
them.  ``split-pretraining`` keeps a cohort id as the CSV spells it,
where the JAX package's pandas reads '0012' as 12 (whose patient
directory does not exist).

  python -m deepards_tpu_torch.cli.create_datasets build-bm-corpus \
      -dp DATA -o OUT [--n-clusters 10] [--breaths-per-clust 20]
"""
import argparse
import csv
import os
from glob import glob

import numpy as np

from deepards_tpu_torch.data.breath import flow_time_features
from deepards_tpu_torch.data.reader import (
    read_processed_file,
    write_processed_file,
)


def _kmeans(x, k, iters=50, seed=0):
    """Small dependency-free KMeans (lloyd) for breath clustering."""
    rng = np.random.default_rng(seed)
    x = np.asarray(x, np.float64)
    k = min(k, len(x))
    centers = x[rng.choice(len(x), k, replace=False)]
    for _ in range(iters):
        d = ((x[:, None] - centers[None]) ** 2).sum(-1)
        labels = d.argmin(1)
        new = np.array([
            x[labels == j].mean(0) if (labels == j).any() else centers[j]
            for j in range(k)
        ])
        if np.allclose(new, centers):
            break
        centers = new
    return labels


def build_bm_corpus(data_path, out_path, experiment_num=1,
                    n_clusters=10, breaths_per_clust=20, seed=0):
    """(reference: create_separate_breath_meta_dataset.py collect_data:16)"""
    raw_files = sorted(glob(os.path.join(
        data_path, "experiment{}".format(experiment_num), "all_data",
        "raw", "*", "*.raw.npy",
    )))
    rng = np.random.default_rng(seed)
    n_out = 0
    for filename in raw_files:
        pt = filename.split(os.sep)[-2]
        breaths = list(read_processed_file(filename))
        usable = [b for b in breaths if len(b["flow"]) >= 21]
        if len(usable) < n_clusters:
            selected = usable
        else:
            feats = np.array([
                flow_time_features(b["flow"], b.get("pressure"))
                for b in usable
            ])
            ok = ~np.any(np.isnan(feats) | np.isinf(feats), axis=1)
            usable = [b for b, good in zip(usable, ok) if good]
            feats = feats[ok]
            if len(usable) < n_clusters:
                selected = usable
            else:
                mu = feats.mean(0)
                sd = feats.std(0)
                sd[sd == 0] = 1
                labels = _kmeans((feats - mu) / sd, n_clusters, seed=seed)
                selected = []
                for c in range(n_clusters):
                    members = [
                        b for b, l in zip(usable, labels) if l == c
                    ]
                    take = min(breaths_per_clust, len(members))
                    pick = rng.choice(len(members), take, replace=False)
                    selected.extend(members[i] for i in pick)
        if not selected:
            continue
        out_dir = os.path.join(out_path, "experiment{}".format(
            experiment_num), "all_data", "raw", pt)
        os.makedirs(out_dir, exist_ok=True)
        out_file = os.path.join(out_dir, os.path.basename(filename))
        write_processed_file(selected, out_file)
        n_out += len(selected)
    return n_out


def split_pretraining(data_path, cohort_file, experiment_num=1):
    """Train = patients NOT in the main cohort, test = cohort patients
    (reference: create_breath_meta_dataset_split.py:9-63)."""
    with open(cohort_file, newline="") as f:
        cohort_pts = {row["Patient Unique Identifier"]
                      for row in csv.DictReader(f)}
    exp_dir = os.path.join(data_path, "experiment{}".format(experiment_num))
    all_raw = os.path.join(exp_dir, "all_data", "raw")
    all_meta = os.path.join(exp_dir, "all_data", "meta")
    for sub, predicate in (
        ("aim1_70_30_training", lambda p: p not in cohort_pts),
        ("aim1_70_30_testing", lambda p: p in cohort_pts),
    ):
        for kind, src_base in (("raw", all_raw), ("meta", all_meta)):
            out = os.path.join(exp_dir, sub, kind)
            os.makedirs(out, exist_ok=True)
            if not os.path.isdir(src_base):
                continue
            for pt in os.listdir(src_base):
                if predicate(pt):
                    dst = os.path.join(out, pt)
                    if not os.path.exists(dst):
                        os.symlink(os.path.join(src_base, pt), dst)


def build_contiguous(data_path, out_path, n_breaths=500, experiment_num=1):
    """First N contiguous usable breaths per patient
    (reference: create_contiguous_vwd_dataset.py)."""
    raw_files = sorted(glob(os.path.join(
        data_path, "experiment{}".format(experiment_num), "all_data",
        "raw", "*", "*.raw.npy",
    )))
    total = 0
    for filename in raw_files:
        pt = filename.split(os.sep)[-2]
        selected = []
        for b in read_processed_file(filename):
            if len(b["flow"]) < 21:
                continue
            selected.append(b)
            if len(selected) >= n_breaths:
                break
        if not selected:
            continue
        out_dir = os.path.join(out_path, "experiment{}".format(
            experiment_num), "all_data", "raw", pt)
        os.makedirs(out_dir, exist_ok=True)
        write_processed_file(
            selected, os.path.join(out_dir, os.path.basename(filename))
        )
        total += len(selected)
    return total


def main(argv=None):
    parser = argparse.ArgumentParser(prog="deepards-create-dataset-torch")
    sub = parser.add_subparsers(dest="cmd", required=True)

    p1 = sub.add_parser("build-bm-corpus")
    p1.add_argument("-dp", "--data-path", required=True)
    p1.add_argument("-o", "--out-path", required=True)
    p1.add_argument("--n-clusters", type=int, default=10)
    p1.add_argument("--breaths-per-clust", type=int, default=20)

    p2 = sub.add_parser("split-pretraining")
    p2.add_argument("-dp", "--data-path", required=True)
    p2.add_argument("-c", "--cohort-file", required=True)

    p3 = sub.add_parser("build-contiguous")
    p3.add_argument("-dp", "--data-path", required=True)
    p3.add_argument("-o", "--out-path", required=True)
    p3.add_argument("--n-breaths", type=int, default=500)

    args = parser.parse_args(argv)
    if args.cmd == "build-bm-corpus":
        n = build_bm_corpus(args.data_path, args.out_path,
                            n_clusters=args.n_clusters,
                            breaths_per_clust=args.breaths_per_clust)
        print("wrote {} breaths".format(n))
    elif args.cmd == "split-pretraining":
        split_pretraining(args.data_path, args.cohort_file)
        print("pretraining split created")
    elif args.cmd == "build-contiguous":
        n = build_contiguous(args.data_path, args.out_path,
                             n_breaths=args.n_breaths)
        print("wrote {} breaths".format(n))


if __name__ == "__main__":
    main()
