"""ProtoPNet prototype-feature analysis CLI.

Counterpart of ``deepards_tpu/cli/protopnet_analysis.py`` (reference:
deepards/models/protopnet1d/protopnet_analysis.py:199-221):

  python -m deepards_tpu_torch.cli.protopnet_analysis CKPT \\
      --kfold-from-pickle dataset.npz --kfold-idx 0 -o out/ \\
      [--n-prototypes 10] [--base-network densenet18] [--device cpu]

Gathers per-window prototype-similarity features of the train and test
sets, probes them with the last layer, and records a random pane of
top-k prototype picks (``<out>/sample-<uuid4>.txt``).  ``-tp`` pickles the
gathered features with the standard library: a dict of numpy arrays
``train_features``/``test_features`` (N, F), ``train_index``/``test_index``
(the rows' window indices), ``train_preds``/``test_preds`` (N, 2),
``coefs`` (F, 2), and the column names ``feature_names`` (where the JAX
package pickles DataFrames).  Runs on --device (default: the card; raises
when there is none).
"""
import argparse
import pickle

import numpy as np


def build_parser():
    parser = argparse.ArgumentParser(description=__doc__)
    parser.add_argument("model", help="saved checkpoint")
    parser.add_argument("--kfold-from-pickle",
                        help="saved .npz dataset for kfold mode")
    parser.add_argument("--kfold-idx", type=int,
                        help="fold index; unset means holdout mode")
    parser.add_argument("--holdout-train-pickle")
    parser.add_argument("--holdout-test-pickle")
    parser.add_argument("-o", "--out-dir", default="protopnet_analysis")
    parser.add_argument("--base-network", default="densenet18")
    parser.add_argument("--n-prototypes", type=int, default=10,
                        help="prototypes per class used at train time")
    parser.add_argument("--topk", type=int, default=40)
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument(
        "-tp", "--analysis-class-to-pickle",
        help="save the gathered features for later reuse")
    parser.add_argument("--device",
                        help="torch device of the model (default: cuda; "
                        "raises when no card is present)")
    return parser


def main(argv=None):
    """Returns (the ``ProtoPNetAnalysis``, the pane's path without its
    extension)."""
    args = build_parser().parse_args(argv)

    from deepards_tpu_torch.config.config import Configuration
    from deepards_tpu_torch.data.dataset import ARDSRawDataset
    from deepards_tpu_torch.device import resolve_device
    from deepards_tpu_torch.explain.prototypes import ProtoPNetAnalysis
    from deepards_tpu_torch.models.protopnet1d import construct_ppnet
    from deepards_tpu_torch.models.registry import get_base_network
    from deepards_tpu_torch.train import checkpoint as ckpt

    device = resolve_device(args.device)
    if args.kfold_idx is not None:
        x_train = ARDSRawDataset.from_pickle(args.kfold_from_pickle)
        x_train.set_kfold_indexes_for_fold(args.kfold_idx)
        x_test = ARDSRawDataset.make_test_dataset_if_kfold(x_train)
        x_test.set_kfold_indexes_for_fold(args.kfold_idx)
    else:
        x_train = ARDSRawDataset.from_pickle(args.holdout_train_pickle)
        x_test = ARDSRawDataset.from_pickle(args.holdout_test_pickle)

    conf = Configuration(overrides={"base_network": args.base_network}).conf
    model = construct_ppnet(
        get_base_network(conf),
        sub_batch_size=x_train.n_sub_batches,
        n_prototypes=args.n_prototypes,
    )
    model.load_state_dict(ckpt.restore(args.model)["params"])

    analysis = ProtoPNetAnalysis(model.to(device), x_train, x_test)
    if args.analysis_class_to_pickle:
        with open(args.analysis_class_to_pickle, "wb") as f:
            pickle.dump({
                "train_features": analysis.train_features,
                "test_features": analysis.test_features,
                "train_index": analysis.train_gt.index,
                "test_index": analysis.test_gt.index,
                "train_preds": analysis.train_preds,
                "test_preds": analysis.test_preds,
                "coefs": analysis.coefs,
                "feature_names": analysis.feature_names,
            }, f)
    base = analysis.make_random_sequence_pane(
        args.out_dir, rng=np.random.default_rng(args.seed), topk=args.topk)
    print(base)
    return analysis, base


if __name__ == "__main__":
    main()
