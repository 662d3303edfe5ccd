"""Per-patient GradCAM ops CLI.

Counterpart of ``deepards_tpu/cli/patient_gradcam.py`` (reference:
deepards/patient_gradcam.py:378-437 __main__):

  python -m deepards_tpu_torch.cli.patient_gradcam CKPT \\
      -pdp dataset.npz --fold 0 --ops dtw_clust \\
      --results-base-dir out/ [--target ground_truth] [--only-patient X] \\
      [--device cpu]

The network is rebuilt from --network/--base-network through the
registry; CKPT is a checkpoint of the port (``train/checkpoint.py``) or an
``.npz`` of the JAX package's flat params.  The cams run on the fold's
TEST patients, as the reference's CLI runs them
(``make_test_dataset_if_kfold``, then ``set_kfold_indexes_for_fold``), on
--device (default: the card; raises when there is none).
"""
import argparse

from deepards_tpu_torch.explain.gradcam import (
    FracTotalNormCam,
    MaxMinNormCam,
    UnNormalizedCam,
)

OPS = ("averages", "medians", "sample_seqs", "read_cam", "rand_sample",
       "dtw_clust", "cam_by_hour")

CAM_CLASSES = {
    "maxmin": MaxMinNormCam,
    "fractotal": FracTotalNormCam,
    "unnormalized": UnNormalizedCam,
}


def build_parser():
    parser = argparse.ArgumentParser(description=__doc__)
    parser.add_argument("model_path", help="path to a saved checkpoint")
    parser.add_argument("-pdp", "--pickled-data-path", required=True,
                        help="path to a saved .npz dataset")
    parser.add_argument("--only-patient")
    parser.add_argument("--fold", type=int, required=True,
                        help="kfold whose TEST patients form the cam set "
                        "(reference: patient_gradcam.py:402-407)")
    parser.add_argument("--ops", choices=OPS, required=True)
    parser.add_argument("-shuf", "--shuffle-samples", action="store_true",
                        help="rand_sample: randomize the patho groups")
    parser.add_argument("--results-base-dir", default="gradcam_results")
    parser.add_argument(
        "--target",
        choices=["ards", "other", "ground_truth", "both"],
        default="ground_truth",
    )
    parser.add_argument("--cam", default="maxmin",
                        choices=sorted(CAM_CLASSES))
    parser.add_argument("--network", default="cnn_linear")
    parser.add_argument("--base-network", default="densenet18")
    parser.add_argument("--hour-start", type=int, default=0,
                        help="cam_by_hour band start")
    parser.add_argument("--hour-end", type=int, default=24)
    parser.add_argument("--seqs-per-hour", type=int, default=None)
    parser.add_argument("--device",
                        help="torch device of the cams and the DTW "
                        "(default: cuda; raises when no card is present)")
    return parser


def main(argv=None, timer=None):
    """Run one op; returns what it returns (``dtw_clust``: the per-patient
    results).  ``timer``: an ``explain.patient_gradcam.StageTimer`` that
    records ``dtw_clust``'s stages."""
    args = build_parser().parse_args(argv)

    from deepards_tpu_torch.config.config import Configuration
    from deepards_tpu_torch.data.dataset import ARDSRawDataset
    from deepards_tpu_torch.device import resolve_device
    from deepards_tpu_torch.explain.patient_gradcam import PatientGradCam
    from deepards_tpu_torch.models.registry import (
        get_base_network,
        get_network_spec,
    )
    from deepards_tpu_torch.train import checkpoint as ckpt

    device = resolve_device(args.device)
    data = ARDSRawDataset.from_pickle(args.pickled_data_path)
    data = ARDSRawDataset.make_test_dataset_if_kfold(data)
    data.set_kfold_indexes_for_fold(args.fold)

    conf = Configuration(overrides={
        "base_network": args.base_network, "network": args.network,
    }).conf
    model = get_network_spec(args.network).build(
        conf, get_base_network(conf), data.n_sub_batches, 0)
    model.load_state_dict(ckpt.restore(args.model_path)["params"])

    pgc = PatientGradCam(
        model.to(device), data, results_dir=args.results_base_dir,
        cam_cls=CAM_CLASSES[args.cam], target=args.target, timer=timer,
    )
    if args.only_patient:
        pgc.gt = pgc.gt.select(pgc.gt.patient.astype(str)
                               == args.only_patient)
        if not len(pgc.gt.index):
            raise SystemExit("patient {} not in fold {}".format(
                args.only_patient, args.fold))

    if args.ops == "rand_sample":
        out = pgc.do_rand_sample(randomize_groups=args.shuffle_samples)
    elif args.ops == "cam_by_hour":
        out = pgc.do_cam_by_hour(
            hour_start=args.hour_start, hour_end=args.hour_end,
            n_sequences_per_hour=args.seqs_per_hour,
        )
    else:
        out = pgc.do_op(args.ops)
    print(args.results_base_dir)
    return out


if __name__ == "__main__":
    main()
