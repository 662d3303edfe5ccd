"""Similar/dissimilar-cohort experiment generator.

Counterpart of ``deepards_tpu/cli/sim_dissim.py`` (reference:
deepards/sim_dissim_experiments_script.py, the generated
deepards/data_split_files/*.yml and
scripts/hetero/train_sim_test_sim_dissim.py):
build the inter-patient DTW matrix on ``--device`` (default: the card),
pick maximally similar and dissimilar patho-balanced cohorts, and write
split files for ``cli.perform_data_splitting preset_file``, through
``config.splitfile`` (no PyYAML).  ``breakdown`` reads the port's own
results JSON.  Run: ``python -m deepards_tpu_torch.cli.sim_dissim
{generate,hetero,breakdown} ...``.
"""
import argparse
import json
import os

import numpy as np

from deepards_tpu_torch.config import splitfile
from deepards_tpu_torch.dtw.lib import (
    find_patient_similarity,
    patho_by_patient,
    pick_dissimilar_pts,
    pick_similar_pts,
)


def generate_split_files(dataset, out_dir, n_pts=10, retrieve_n=2,
                         mean_similarity_thresh=0.8, dist_method="random",
                         device=None):
    os.makedirs(out_dir, exist_ok=True)
    mat = find_patient_similarity(dataset, dist_method=dist_method,
                                  device=device)
    sims = pick_similar_pts(
        mat, dataset, n_pts, retrieve_n=retrieve_n,
        mean_similarity_thresh=mean_similarity_thresh,
    )
    diss = pick_dissimilar_pts(
        mat, dataset, n_pts, retrieve_n=retrieve_n,
        mean_similarity_thresh=mean_similarity_thresh,
    )
    written = []
    for kind, sets in (("sim", sims), ("dissim", diss)):
        for i, (cost, pts) in enumerate(sets):
            path = os.path.join(
                out_dir, "{}_{}pts_v{}.yml".format(kind, n_pts, i))
            splitfile.write(path, {
                "train": list(pts),
                "test": sorted(set(mat.patients) - set(pts)),
                "cost": float(cost),
                "kind": kind,
            })
            written.append(path)
    return written


def hetero_split(similarity, dataset, n, rng, train_n=40, test_n=6,
                 retrieve_n=10, mean_similarity_thresh=0.7):
    """One train-on-similar / test-on-sim+dissim split (reference:
    scripts/hetero/train_sim_test_sim_dissim.py:20-49): train is the n-th
    most similar patho-balanced set; the test set is a dissimilar set
    picked without train, plus a similar set picked without both; one
    patient of opposite pathophysiology is trimmed from each test group
    at random to rebalance."""

    def _nth(sets, what):
        """The n-th candidate set, clamped: a small cohort can give fewer
        distinct sets than retrieve_n."""
        if not sets:
            raise ValueError(
                "no {} candidate sets found - cohort too small or "
                "mean_similarity_thresh too strict".format(what))
        return list(sets[min(n, len(sets) - 1)][1])

    train = _nth(pick_similar_pts(
        similarity, dataset, train_n, retrieve_n=retrieve_n,
        mean_similarity_thresh=mean_similarity_thresh), "similar-train")
    dissim = _nth(pick_dissimilar_pts(
        similarity, dataset, test_n, exclude=train, retrieve_n=retrieve_n,
        mean_similarity_thresh=mean_similarity_thresh), "dissimilar-test")
    sim = _nth(pick_similar_pts(
        similarity, dataset, test_n, exclude=train + dissim,
        retrieve_n=retrieve_n,
        mean_similarity_thresh=mean_similarity_thresh), "similar-test")

    patho = patho_by_patient(dataset)
    trim_dissim_cls, trim_sim_cls = (0, 1) if rng.random() > 0.5 else (1, 0)

    def _trim(pts, cls):
        if len(pts) <= 1:  # never trim a group to empty
            return pts
        candidates = [p for p in pts if patho[p] == cls]
        if not candidates:
            return pts
        drop = candidates[int(rng.integers(0, len(candidates)))]
        return [p for p in pts if p != drop]

    dissim = _trim(dissim, trim_dissim_cls)
    sim = _trim(sim, trim_sim_cls)
    return {"train": train, "test": sim + dissim, "similar": sim,
            "dissimilar": dissim}


def generate_hetero_splits(dataset, out_dir, n_splits=10, train_n=40,
                           test_n=6, mean_similarity_thresh=0.7,
                           dist_method="random", seed=0, similarity=None,
                           device=None):
    """Write train_sim_test_sim_dissim_split_{n}.yml split files, each for
    ``cli.perform_data_splitting preset_file`` and then the generated
    ``train_sim_test_sim_dissim_split_{n}`` experiment
    (reference: scripts/hetero/train_sim_test_sim_dissim.py:91-131)."""
    os.makedirs(out_dir, exist_ok=True)
    if similarity is None:
        similarity = find_patient_similarity(
            dataset, dist_method=dist_method, device=device)
    rng = np.random.default_rng(seed)
    written = []
    # numbered from 1 with candidate index == split number: the reference
    # runner skips candidate 0 and names split_n after candidate n
    for n in range(1, n_splits):
        split = hetero_split(
            similarity, dataset, n, rng, train_n=train_n, test_n=test_n,
            retrieve_n=n_splits, mean_similarity_thresh=mean_similarity_thresh)
        path = os.path.join(
            out_dir, "train_sim_test_sim_dissim_split_{}.yml".format(n))
        splitfile.write(path, split)
        written.append(path)
    return written


def sim_dissim_breakdown(patient_results, split):
    """Patient-level stats of the last epoch, by the test set's similar
    and dissimilar groups: {group: rows of ``STAT_COLUMNS`` + group}.
    ``patient_results``: rows of ``DeepARDSResults.results``."""
    from deepards_tpu_torch.eval.metrics import aggregate_stats

    frames = {}
    for kind in ("similar", "dissimilar"):
        pts = set(str(p) for p in split.get(kind, []))
        sub = [r for r in patient_results if str(r["patient"]) in pts]
        if not sub:
            continue
        last = max(r["epoch_num"] for r in sub)
        sub = [r for r in sub if r["epoch_num"] == last]
        stats = aggregate_stats(sub, sub[0]["fold_num"], sub[0]["epoch_num"])
        frames[kind] = [dict(row, group=kind) for row in stats]
    return frames


def read_patient_results(path):
    """Patient rows from a run's ``*_results_*.json`` record or its
    ``*_patient_results.json``."""
    with open(path) as f:
        obj = json.load(f)
    return obj["results"] if isinstance(obj, dict) else obj


def main(argv=None):
    parser = argparse.ArgumentParser(prog="deepards-sim-dissim-torch")
    sub = parser.add_subparsers(dest="command", required=True)

    gen = sub.add_parser(
        "generate", help="similar/dissimilar cohort split files")
    gen.add_argument("--train-from-pickle", required=True,
                     help="a saved .npz dataset")
    gen.add_argument("-o", "--out-dir", default="data_split_files")
    gen.add_argument("--n-pts", type=int, default=10)
    gen.add_argument("--retrieve-n", type=int, default=2)
    gen.add_argument("--dist-method", choices=["random", "same_ordered"],
                     default="random")

    het = sub.add_parser(
        "hetero",
        help="train-similar/test-sim+dissim split files (reference "
             "scripts/hetero/train_sim_test_sim_dissim.py)")
    het.add_argument("--train-from-pickle", required=True,
                     help="a saved .npz dataset")
    het.add_argument("-o", "--out-dir", default="data_split_files")
    het.add_argument("--n-splits", type=int, default=10)
    het.add_argument("--train-n", type=int, default=40)
    het.add_argument("--test-n", type=int, default=6)
    het.add_argument("--mean-similarity-thresh", type=float, default=0.7)
    het.add_argument("--dist-method", choices=["random", "same_ordered"],
                     default="random")
    het.add_argument("--seed", type=int, default=0)
    for p in (gen, het):
        p.add_argument("--device",
                       help="torch device of the DTW sweep (default: cuda; "
                       "raises when no card is present)")

    brk = sub.add_parser(
        "breakdown",
        help="patient-level stats split by similar vs dissimilar test "
             "groups")
    brk.add_argument("patient_results",
                     help="a run's *_results_*.json or *_patient_results.json")
    brk.add_argument("split_file", help="train_sim_test_sim_dissim yml")
    args = parser.parse_args(argv)

    if args.command == "breakdown":
        from deepards_tpu_torch.eval.metrics import STAT_COLUMNS, _print_table

        frames = sim_dissim_breakdown(
            read_patient_results(args.patient_results),
            splitfile.read(args.split_file))
        for kind, stats in frames.items():
            print("---- {} test patients ----".format(kind))
            _print_table(stats, STAT_COLUMNS + ["group"])
        return frames

    from deepards_tpu_torch.data.dataset import ARDSRawDataset

    ds = ARDSRawDataset.from_pickle(args.train_from_pickle)
    if ds.total_kfolds:
        ds.set_kfold_indexes_for_fold(0)
    if args.command == "hetero":
        written = generate_hetero_splits(
            ds, args.out_dir, n_splits=args.n_splits, train_n=args.train_n,
            test_n=args.test_n,
            mean_similarity_thresh=args.mean_similarity_thresh,
            dist_method=args.dist_method, seed=args.seed, device=args.device,
        )
    else:
        written = generate_split_files(
            ds, args.out_dir, n_pts=args.n_pts, retrieve_n=args.retrieve_n,
            dist_method=args.dist_method, device=args.device,
        )
    for path in written:
        print("wrote", path)
    return written


if __name__ == "__main__":
    main()
