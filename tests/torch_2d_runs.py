"""Shared helpers of the whole 2D runs against the JAX package
(``test_torch_2d_run_*.py``): the shared synthetic cohort (8 patients,
S = 4: 2 images a patient), 2 folds, float32, SGD at lr 1e-4 (where a run
is well conditioned), narrow 2D densenets (growth 8, 16 initial
features) in both packages, each fold of the port starting from the
params the JAX trainer initialised for it."""
import numpy as np
from test_torch_configs_2_3_4 import random_params

import deepards_tpu.models.registry as jregistry
import deepards_tpu_torch.models.registry as tregistry
from deepards_tpu.models import densenet2d as jdensenet
from deepards_tpu_torch.models import densenet2d
from deepards_tpu_torch.transplant import transplant

NARROW = dict(growth_rate=8, num_init_features=16)
BACKBONES = ("densenet18_2d", "densenet18_2x1d")


def overrides(cohort, tmp_path, **over):
    base = dict(
        data_path=cohort["data_path"], cohort_file=cohort["cohort_file"],
        experiment_num=1, base_network="densenet18",
        dataset_type="unpadded_centered_sequences", n_sub_batches=4,
        kfolds=2, epochs=2, batch_size=2, optimizer="sgd",
        learning_rate=0.0001, weight_decay=0.0001, clip_grad=True,
        clip_val=0.01, oversample_minority=True, compute_dtype="float32",
        fused_steps=1, dp_devices=1, results_dir=str(tmp_path / "results"),
        seed=7)
    base.update(over)
    return base


def narrow_backbones(mp):
    """Both registries' 2D backbones at NARROW widths."""
    for name in BACKBONES:
        kernel = (lambda k: (k, 1)) if "2x1d" in name else (
            lambda k: (k, k))
        mp.setitem(jregistry.BASE_NETWORKS, name,
                   lambda conf, kernel=kernel: jdensenet.DenseNet2D(
                       block_kernel=kernel(conf.get("block_kernel_size", 3)
                                           or 3), **NARROW))
        mp.setitem(tregistry.BASE_NETWORKS, name,
                   lambda conf, c, kernel=kernel: densenet2d.DenseNet2D(
                       block_kernel=kernel(conf.get("block_kernel_size", 3)
                                           or 3), in_channels=c, **NARROW))


class NumpyInit:
    """A flax module whose ``init`` gives numpy-drawn params (prototypes
    uniform in [0, 1)), each recorded transplanted in ``inits``."""

    def __init__(self, module, inits):
        self._module = module
        self._inits = inits

    def __getattr__(self, name):
        return getattr(self._module, name)

    def init(self, rngs, x, *args):
        params = random_params(self._module, len(self._inits), x, *args)
        if "prototype_vectors" in params:
            params["prototype_vectors"] = np.random.default_rng(
                len(self._inits)).uniform(
                    size=params["prototype_vectors"].shape).astype(
                        np.float32)
        self._inits.append(transplant(params))
        return {"params": params}


def from_inits(trainer_class, inits, mp):
    """The port's ``trainer_class`` starts each fold from the next of
    ``inits``."""
    runs = iter(inits)
    mp.setattr(trainer_class, "init_model",
               lambda self, model, fold: model.load_state_dict(next(runs)))


def flat_params(tree, prefix=""):
    """A nested flax param tree as "a/b/c" keys."""
    out = {}
    for k, v in tree.items():
        if hasattr(v, "items"):
            out.update(flat_params(v, prefix + k + "/"))
        else:
            out[prefix + k] = v
    return out


def meters(results, prefixes):
    return {k: v.values for k, v in results.reporting.meters.items()
            if k.startswith(prefixes)}


def assert_meters_close(port, jax_results, prefixes, count, atol=1e-4):
    got, want = meters(port, prefixes), meters(jax_results, prefixes)
    assert got.keys() == want.keys() and len(got) == count, sorted(got)
    for name in want:
        assert len(got[name]) == len(want[name]), name
        np.testing.assert_allclose(got[name], want[name], atol=atol, rtol=0,
                                   err_msg=name)


def assert_votes_equal(port, jax_results, rows):
    want = jax_results.results.to_dict(orient="records")
    assert port.results == want and len(want) == rows
    for fold in (0, 1):
        assert port.get_meter("test_auc", fold).values == \
            jax_results.get_meter("test_auc", fold).values
