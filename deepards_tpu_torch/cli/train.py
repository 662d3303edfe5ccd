"""Training CLI with the JAX package's flag surface.

Counterpart of ``deepards_tpu/cli/train.py``: flags map 1:1 onto the same
config keys, so experiment yml files and launch commands work unchanged,
plus ``--device`` (the counterpart of ``--platform``), which defaults to
the card.  Run: ``python -m deepards_tpu_torch.cli.train -co exp.yml
--data-path <cohort dir> [--device cpu]``.

With ``DEEPARDS_TORCH_LAUNCH_COUNTS=1`` in its environment a run writes
its process's hand-written kernel launches (from 0 at its start) to
``<results dir>/kernel_launches.json`` when it ends, so a caller can
count the launches of ranks it did not start itself (``chip_smoke.py``'s
``distributed`` phase reads each rank of ``cli.launch_distributed``).
"""
import argparse
import json
import os

from deepards_tpu_torch.config.config import Configuration


LAUNCH_COUNTS_ENV = "DEEPARDS_TORCH_LAUNCH_COUNTS"
LAUNCH_COUNTS_FILE = "kernel_launches.json"

DATASET_TYPES = [
    "padded_breath_by_breath",
    "unpadded_sequences",
    "unpadded_centered_sequences",
    "unpadded_downsampled_sequences",
    "unpadded_centered_downsampled_sequences",
    "spaced_padded_breath_by_breath",
    "stretched_breath_by_breath",
    "padded_breath_by_breath_with_full_bm_target",
    "padded_breath_by_breath_with_limited_bm_target",
    "padded_breath_by_breath_with_experimental_bm_target",
    "padded_breath_by_breath_with_flow_time_features",
    "unpadded_downsampled_autoencoder_sequences",
    "unpadded_centered_with_bm",
]


def build_parser():
    parser = argparse.ArgumentParser(prog="deepards-train-torch")

    def flag(name, help=""):
        # boolean flags default to None so yml-set booleans survive the
        # config merge (reference: defaults.yml:9)
        parser.add_argument(name, action="store_true", help=help, default=None)

    parser.add_argument("-co", "--config-override")
    parser.add_argument("-dp", "--data-path")
    parser.add_argument("-en", "--experiment-num", type=int)
    parser.add_argument("-c", "--cohort-file")
    parser.add_argument("-n", "--network")
    parser.add_argument("-e", "--epochs", type=int)
    parser.add_argument("-p", "--train-from-pickle")
    parser.add_argument("--train-to-pickle")
    parser.add_argument("--test-from-pickle")
    parser.add_argument("--test-to-pickle")
    parser.add_argument("-b", "--batch-size", type=int)
    parser.add_argument("--base-network")
    parser.add_argument("-lc", "--loss-calc",
                        choices=["all_breaths", "last_breath"])
    parser.add_argument("-nb", "--n-sub-batches", type=int)
    flag("--no-print-progress")
    parser.add_argument("--kfolds", type=int)
    parser.add_argument("-rip", "--initial-planes", type=int)
    parser.add_argument("-rfpt", "--resnet-first-pool-type",
                        choices=["max", "avg"])
    flag("--no-test-after-epochs")
    flag("--debug", "run a single batch per epoch")
    parser.add_argument("--optimizer", choices=["adam", "sgd"])
    parser.add_argument("-dt", "--dataset-type", choices=DATASET_TYPES)
    parser.add_argument("-lr", "--learning-rate", type=float)
    parser.add_argument("--loader-threads", type=int)
    parser.add_argument("--save-model")
    flag("--save-model-per-epoch")
    parser.add_argument("--load-base-network")
    parser.add_argument("--load-checkpoint")
    parser.add_argument("--rng-impl", choices=("rbg", "threefry",
                        "unsafe_rbg"),
                        help="the JAX package's dropout PRNG; accepted, "
                        "no effect in the port")
    parser.add_argument("--checkpoint-every-n-steps", type=int,
                        help="save a mid-epoch resume checkpoint every N "
                             "train steps (requires --save-model)")
    flag("--no-train")
    flag("--resnet-double-conv")
    flag("--bm-to-linear")
    parser.add_argument("-exp", "--experiment-name")
    parser.add_argument("--downsample-factor", type=float)
    parser.add_argument("-wd", "--weight-decay", type=float)
    parser.add_argument("-loss", "--loss-func",
                        choices=["bce", "vacillating", "confidence"])
    parser.add_argument("--valpha", type=float, default=float("inf"))
    parser.add_argument("--conf-beta", type=float, default=1.0)
    parser.add_argument("--time-series-hidden-units", type=int)
    parser.add_argument("--transformer-blocks", type=int)
    flag("--unshuffled")
    parser.add_argument("--load-siamese",
                        help="refused: read by nothing in either package; "
                        "--load-base-network splices a siamese checkpoint's "
                        "breath_block into siamese_pretrained")
    parser.add_argument("--siamese-time-layer",
                        choices=["none", "lstm", "transformer"],
                        help="siamese_pretrained's layer over the windows "
                        "(the configuration key siamese_time_layer)")
    parser.add_argument("--fl-gamma", type=float)
    parser.add_argument("--fl-alpha", type=float)
    flag("--oversample-minority")
    parser.add_argument("--oversample-all-factor", type=float)
    parser.add_argument("-usf", "--undersample-factor", type=float)
    parser.add_argument("-usdf", "--undersample-std-factor", type=float)
    flag("--reshuffle-oversample-per-epoch")
    flag("--freeze-base-network")
    flag("--stop-on-loss")
    parser.add_argument("--stop-thresh", type=float)
    parser.add_argument("--stop-after-epoch", type=int)
    flag("--clip-grad")
    parser.add_argument("--clip-val", type=float)
    parser.add_argument("--holdout-set-type")
    flag("--final-validation")
    flag("--plot-untiled-disease-evol")
    flag("--plot-tiled-disease-evol")
    flag("--plot-dtw-with-disease")
    parser.add_argument("--plot-pt-dtw-by-minute")
    flag("--perform-dtw-preprocessing")
    parser.add_argument("--train-pt-frac", type=float)
    parser.add_argument("--transforms",
                        choices=["ie_ww", "naive_ww", "ie_ww_i_or_e"],
                        nargs="*")
    parser.add_argument("-tp", "--transform-probability", type=float)
    flag("--use-i")
    parser.add_argument("-r2", "--drop-if-under-r2", type=float)
    flag("--drop-i-lim")
    flag("--drop-e-lim")
    parser.add_argument("--truncate-e-lim", type=float, default=None)
    parser.add_argument("--only-fold", type=int, default=None)
    parser.add_argument("--n-warm-epochs", type=int)
    parser.add_argument("-pse", "--push-start-epoch", type=int)
    parser.add_argument("--push-every-n", type=int)
    parser.add_argument("--n-push-iters", type=int)
    parser.add_argument("--clust-lambda", type=float)
    parser.add_argument("--sep-lambda", type=float)
    parser.add_argument("-vse", "--viz-start-epoch", type=int)
    parser.add_argument("--viz-every-n", type=int)
    parser.add_argument("--prototype-results-dir")
    parser.add_argument("--prototype-fname-prefix")
    parser.add_argument("-np", "--n-prototypes", type=int)
    parser.add_argument("-ic", "--incorrect-strength", type=float)
    parser.add_argument("--saved-models-dir")
    flag("--average-linear-layer")
    flag("--use-l1")
    flag("--print-progress")
    parser.add_argument("-2dt", "--two-dim-transforms", nargs="*")
    flag("--with-fft")
    flag("--only-fft")
    parser.add_argument("-bks", "--block-kernel-size", type=int)
    parser.add_argument("--multitask-epochs", type=int)
    flag("--row-mix")
    flag("--fft-real-only")
    parser.add_argument("--butter-low", type=float)
    parser.add_argument("--butter-high", type=float)
    flag("--random-kfold")
    flag("--bootstrap")
    parser.add_argument("--post-hoc-downsampling", type=float)
    parser.add_argument("--fft-filtering-low", type=float)
    parser.add_argument("--fft-filtering-high", type=float)
    parser.add_argument("--dp-devices", type=int,
                        help="shards of each batch on the data axis (-1 = "
                        "the number of processes; one process runs any k "
                        "itself, k processes one shard each)")
    parser.add_argument("--compute-dtype",
                        choices=["bfloat16", "float32"])
    parser.add_argument("--bn-scope", choices=["batch", "sequence"],
                        help="norm-statistics scope: 'batch' folds all "
                        "B*S windows into one norm batch (fast default); "
                        "'sequence' reproduces the reference's "
                        "per-sample BN statistics exactly "
                        "(torch_cnn_linear_network.py:104-113)")
    parser.add_argument("--seed", type=int)
    parser.add_argument("--results-dir")
    flag("--parallel-folds",
         "train all kfolds simultaneously (a standard classifier)")
    parser.add_argument("--fused-steps", type=int,
                        help="host epochs gather, augment and copy this "
                        "many batches at a time (default 8); every step "
                        "replays the fold's CUDA graph on the card")
    # multi-process / multi-host (usually set by cli.launch_distributed)
    parser.add_argument("--distributed-coordinator",
                        help="host:port of rank 0 (torch.distributed over "
                        "gloo)")
    parser.add_argument("--num-processes", type=int)
    parser.add_argument("--process-id", type=int)
    parser.add_argument("--platform", choices=["cpu", "tpu"],
                        help="the JAX package's backend flag: cpu means "
                        "--device cpu; the port has no tpu")
    parser.add_argument("--device",
                        help="torch device to train on (default: cuda; "
                        "raises when no card is present)")
    return parser


def main(argv=None):
    parser = build_parser()
    args = parser.parse_args(argv)
    if args.platform == "tpu":
        parser.error("--platform tpu: the port runs on CUDA or the CPU")
    if args.platform == "cpu" and args.device is None:
        args.device = "cpu"
    counting = os.environ.get(LAUNCH_COUNTS_ENV) == "1"
    if counting:
        from deepards_tpu_torch.ops import dtw

        dtw.launches = 0
    if args.distributed_coordinator:
        # before any device work, as deepards_tpu/cli/train.py:186-194
        from deepards_tpu_torch.parallel.mesh import initialize_distributed

        initialize_distributed(args.distributed_coordinator,
                               args.num_processes, args.process_id)
    conf = Configuration(args)
    # oversample alias quirk (reference: train_ards_detector.py:80-83)
    if "oversample" in conf.conf and conf.get("oversample") is not None:
        conf.conf["oversample_minority"] = conf.conf["oversample"]
    if conf.get("save_model_per_epoch") and not conf.get("save_model"):
        raise SystemExit(
            "Must specify a filename to save your model using --save-model"
        )

    from deepards_tpu_torch.train.loop import make_trainer

    trainer = make_trainer(conf)
    print("Run start time: {}".format(trainer.start_time))
    trainer.train_and_test()
    print("Run start time: {}".format(trainer.start_time))
    if counting:
        results_dir = conf.get("results_dir") or "results"
        os.makedirs(results_dir, exist_ok=True)
        with open(os.path.join(results_dir, LAUNCH_COUNTS_FILE), "w") as f:
            json.dump({"dtw": dtw.launches}, f)
    return trainer


if __name__ == "__main__":
    main()
