"""CLI of the frequency-domain GradCAM studies.

Counterpart of ``deepards_tpu/cli/cam_analytics.py`` (reference:
deepards/gradcam.py:1096-1159):

  python -m deepards_tpu_torch.cli.cam_analytics one-d \\
      -p dataset.npz --model-pattern 'ckpt-fold{fold}' --folds 5 -o out/
  python -m deepards_tpu_torch.cli.cam_analytics two-d ...
  python -m deepards_tpu_torch.cli.cam_analytics butter \\
      -p filtered.npz --no-filter-pickle raw.npz -lf 0 -hf 5 ...
  python -m deepards_tpu_torch.cli.cam_analytics butter-plot \\
      -p raw.npz --index 0

Each fold's checkpoint (a port checkpoint or an ``.npz`` of the JAX
package's flat params) is loaded into the network --network and
--base-network name, built with the dataset's channels and breaths a
window (flax infers them at init; torch needs them at build).  The
``two-d`` study, as the JAX package's, runs that 1D network and repeats
its cam over the rows.  Each study writes its columns to
``<out>/<study>.npz`` (the ``butter`` prototypes as
``prototype_<patho>_<tag>``; ``butter-plot`` its filtered breath as
``signal``).  The PNGs are drawn with matplotlib on the CPU host only: on
the card, or without matplotlib, each PNG stage is refused by name.  The
cams run on --device (default: the card; raises when there is none).
"""
import argparse
import os

import numpy as np

CAM_CLASSES = ("unnormalized", "maxmin")


def build_parser():
    parser = argparse.ArgumentParser(description=__doc__)
    sub = parser.add_subparsers(dest="cmd", required=True)

    def common(p):
        p.add_argument("-p", "--pickled-dataset", required=True,
                       help="saved .npz dataset")
        p.add_argument("--model-pattern", required=True,
                       help="checkpoint path with {fold} placeholder")
        p.add_argument("--folds", type=int, default=5)
        p.add_argument("-o", "--out-dir", default="cam_analytics_out")
        p.add_argument("-n", "--n-samps", type=int, default=50)
        p.add_argument("--network", default="cnn_linear")
        p.add_argument("--base-network", default="densenet18")
        p.add_argument("--cam", default="unnormalized", choices=CAM_CLASSES)
        p.add_argument("--device",
                       help="torch device of the cams (default: cuda; "
                       "raises when no card is present)")

    for name in ("one-d", "two-d", "butter"):
        p = sub.add_parser(name)
        common(p)
        if name == "butter":
            p.add_argument("--no-filter-pickle", required=True)
            p.add_argument("-lf", "--hz-low", type=float, required=True)
            p.add_argument("-hf", "--hz-high", type=float, required=True)
            p.add_argument("--experiment", default="butter")

    p = sub.add_parser("butter-plot")
    p.add_argument("-p", "--pickled-dataset", required=True)
    p.add_argument("--index", type=int, required=True)
    p.add_argument("-lf", "--hz-low", type=float, default=0.0)
    p.add_argument("-hf", "--hz-high", type=float, default=25.0)
    p.add_argument("--experiment", default="butter")
    p.add_argument("-o", "--out-dir", default="cam_analytics_out")
    p.add_argument("--device",
                   help="where the PNG may be drawn: cpu (default: cuda, "
                   "where the PNG stage is refused)")
    return parser


def build_model(network, base_network, dataset):
    """The network from ``Configuration`` defaults over the dataset's
    channels and breaths a window."""
    from deepards_tpu_torch.config.config import Configuration
    from deepards_tpu_torch.models.registry import (
        get_base_network,
        get_network_spec,
    )

    conf = Configuration(overrides={"base_network": base_network,
                                    "network": network}).conf
    _, s, c, _ = dataset.cache.data.shape
    return get_network_spec(network).build(conf, get_base_network(conf, c),
                                           s, 0)


def models_by_fold(network, base_network, dataset, pattern, n_folds, device):
    """{fold: the network holding that fold's checkpoint, on ``device``}."""
    from deepards_tpu_torch.train import checkpoint as ckpt

    out = {}
    for fold in range(n_folds):
        model = build_model(network, base_network, dataset)
        model.load_state_dict(ckpt.restore(pattern.format(fold=fold))[
            "params"])
        out[fold] = model.to(device).eval()
    return out


def save_columns(path, columns):
    np.savez(path, **{k.replace(" ", "_"): v for k, v in columns.items()})
    return path


def main(argv=None):
    """Run one study; returns its result (``butter-plot``: the signal)."""
    args = build_parser().parse_args(argv)

    from deepards_tpu_torch.data.dataset import ARDSRawDataset
    from deepards_tpu_torch.device import resolve_device
    from deepards_tpu_torch.explain import frequency_analytics as fa
    from deepards_tpu_torch.explain.gradcam import (
        MaxMinNormCam,
        UnNormalizedCam,
    )
    from deepards_tpu_torch.utils.figures import draw_or_refuse

    device = resolve_device(args.device)
    os.makedirs(args.out_dir, exist_ok=True)
    ds = ARDSRawDataset.from_pickle(args.pickled_dataset)
    if args.cmd == "butter-plot":
        signal = fa.butter_plots(ds, args.index, args.hz_low, args.hz_high)
        np.savez(os.path.join(args.out_dir, "butter_plot.npz"),
                 signal=signal)
        png = os.path.join(args.out_dir,
                           "butterworth-plt-{}-idx{}-{}-{}hz.png".format(
                               args.experiment, args.index, args.hz_low,
                               args.hz_high))
        draw_or_refuse([(png, lambda p: fa.draw_signal(signal, p))], device)
        return signal

    cam_cls = {"unnormalized": UnNormalizedCam,
               "maxmin": MaxMinNormCam}[args.cam]
    models = models_by_fold(args.network, args.base_network, ds,
                            args.model_pattern, args.folds, device)
    if args.cmd == "one-d":
        res = fa.one_d_analytics(cam_cls, ds, models, n_samps=args.n_samps)
        tables = ("intensity", "bands", "splices")
    elif args.cmd == "two-d":
        res = fa.two_d_analytics(cam_cls, ds, models, n_samps=args.n_samps)
        tables = ("intensity",)
    else:
        no_filter = ARDSRawDataset.from_pickle(args.no_filter_pickle)
        res = fa.butterworth_1d_analytics(cam_cls, ds, no_filter, models,
                                          n_samps=args.n_samps)
        tables = ("intensity",)
        np.savez(os.path.join(args.out_dir, "butter_prototypes.npz"), **{
            "prototype_{}_{}".format(patho, tag): v
            for (patho, tag), v in res["prototypes"].items()})
    stem = args.cmd.replace("-", "_")
    for table in tables:
        print(save_columns(os.path.join(
            args.out_dir, "{}_{}.npz".format(stem, table)), res[table]))
    draw_or_refuse(fa.study_pngs(
        args.cmd, res, args.out_dir, getattr(args, "experiment", None),
        getattr(args, "hz_low", None), getattr(args, "hz_high", None)),
        device)
    return res


if __name__ == "__main__":
    main()
