"""Run configuration with a three-level precedence merge.

Counterpart of ``deepards_tpu/config/config.py``.  Precedence (highest
wins): CLI args > experiment override yml > ``DEFAULTS``.  Boolean flags
of the CLI default to None, so booleans set in a yml survive the merge.

``DEFAULTS`` is ``deepards_tpu/config/defaults.yml`` as a Python dict (a
test holds the two equal).  An experiment file given with ``-co`` is read
by ``config.yamlfile``, the subset of YAML the repo's files use, with no
PyYAML.
"""
from deepards_tpu_torch.config import yamlfile


DEFAULTS = {
    # generic training options
    "data_path": "/fastdata/ardsdetection",
    "experiment_num": 1,
    "cohort_file": "cohort-description.csv",
    "network": "cnn_linear",
    "epochs": 10,
    "batch_size": 16,
    "base_network": "densenet18",
    "loss_calc": "all_breaths",
    "loader_threads": 0,
    # resnet options
    "initial_planes": 64,
    "resnet_first_pool_type": "max",
    # main hyperparameters
    "optimizer": "sgd",
    "dataset_type": "unpadded_centered_sequences",
    "learning_rate": 0.001,
    "n_sub_batches": 20,
    "weight_decay": 0.0001,
    "loss_func": "bce",
    "clip_val": 0.01,
    "time_series_hidden_units": 16,
    "transformer_blocks": 2,
    # focal loss
    "fl_gamma": 2.0,
    "fl_alpha": 0.25,
    # stop if loss too high
    "stop_thresh": 1.5,
    "stop_after_epoch": 1,
    # augmentation options
    "transform_probability": 0.2,
    # protopnet
    "n_warm_epochs": 3,
    "push_start_epoch": 6,
    "clust_lambda": 0.8,
    "sep_lambda": 0.2,
    "viz_start_epoch": 6,
    "push_every_n": 6,
    "n_push_iters": 5,
    "viz_every_n": 4,
    "prototype_results_dir": "prototype_results/",
    "prototype_fname_prefix": "proto",
    "n_prototypes": 10,
    "incorrect_strength": -0.5,
    # other options
    "holdout_set_type": "main",
    "train_pt_frac": 1.0,
    "downsample_factor": 4.0,
    "cuda_device": 0,
    "drop_if_under_r2": 0,
    "oversample_all_factor": 1.0,
    "undersample_factor": -1,
    "undersample_std_factor": 0.2,
    "two_dim_transforms": [],
    "block_kernel_size": 3,
    "multitask_epochs": 15,
    # dtype of the forward; params and grads stay float32
    "compute_dtype": "bfloat16",
    # the JAX package's data-parallel devices; the port takes -1 or 1
    "dp_devices": -1,
    # seed of parameter init, shuffling, sampling and dropout
    "seed": 42,
    # host epochs gather, augment and copy this many batches at a time
    "fused_steps": 8,
    # queue the epochs' result recording until the fold ends
    "defer_fetch": True,
    # the JAX package's dropout PRNG; no effect in the port
    "rng_impl": "rbg",
}


def load_defaults():
    return {k: list(v) if isinstance(v, list) else v
            for k, v in DEFAULTS.items()}


def read_experiment_file(path):
    """The overrides of an experiment ``.yml``, as PyYAML's loader reads
    them."""
    return yamlfile.read(path)


class Configuration(object):
    """Merged run configuration.

    Accepts an argparse.Namespace (the CLI) or a plain dict of overrides
    for programmatic use.  Attributes resolve from the merged dict.
    """

    def __init__(self, parser_args=None, overrides=None):
        self.conf = load_defaults()

        override_path = None
        if parser_args is not None:
            override_path = getattr(parser_args, "config_override", None)
        if override_path:
            self.conf.update(read_experiment_file(override_path))

        if parser_args is not None:
            # CLI wins, but only for args explicitly set (non-None) or
            # args that have no default entry at all
            for k, v in parser_args.__dict__.items():
                if v is not None or k not in self.conf:
                    self.conf[k] = v

        if overrides:
            self.conf.update(overrides)

    def get(self, key, default=None):
        return self.conf.get(key, default)

    def __getattr__(self, attr):
        if attr == "conf":
            raise AttributeError(attr)
        try:
            return self.conf[attr]
        except KeyError:
            raise AttributeError(attr)

    def __contains__(self, key):
        return key in self.conf

    def __repr__(self):
        return "Configuration({})".format(self.conf)
