"""``siamese_pretrained`` with ``--load-base-network`` from a siamese
checkpoint starts from that checkpoint's backbone, in both packages: a
siamese run (one batch) saves its tower, and ``siamese_pretrained`` (the
LSTM time layer, no training) keeps it and has a head of its own."""
import jax
import numpy as np
import pytest
import torch
from test_torch_siamese_run import _narrow, _overrides
from torch_2d_runs import flat_params

import deepards_tpu.train.loop as jloop
import deepards_tpu_torch.train.loop as tloop
from deepards_tpu.config import Configuration as JaxConfiguration
from deepards_tpu.train import checkpoint as jcheckpoint
from deepards_tpu_torch.config.config import Configuration
from deepards_tpu_torch.train import checkpoint
from deepards_tpu_torch.transplant import transplant

# parallel test workers share the cores: one torch thread each
torch.set_num_threads(1)


def test_siamese_pretrained_loads_the_siamese_backbone(synthetic_cohort,
                                                       tmp_path):
    """A siamese run saves its tower; ``siamese_pretrained`` with
    ``load_base_network`` from it (no training) keeps that backbone, in
    both packages, and its head is its own."""
    pretrained = dict(network="siamese_pretrained", epochs=1, no_train=True,
                      siamese_time_layer="lstm", time_series_hidden_units=8)
    with pytest.MonkeyPatch.context() as mp:
        _narrow(mp)
        for side, make, conf_cls in (("jax", jloop.make_trainer,
                                      JaxConfiguration),
                                     ("port", tloop.make_trainer,
                                      Configuration)):
            kw = {} if side == "jax" else {"device": "cpu"}
            saved = make(conf_cls(overrides=_overrides(
                synthetic_cohort, tmp_path / side, epochs=1, debug=True,
                save_model="siamese.pt")), verbose=False, **kw)
            saved.train_and_test()
            path = str(tmp_path / side / "models" / "siamese")
            trainer = make(conf_cls(overrides=_overrides(
                synthetic_cohort, tmp_path / side, load_base_network=path,
                **pretrained)), verbose=False, **kw)
            trainer.train_and_test()
            if side == "jax":
                want = transplant(flat_params(
                    jcheckpoint.load_params(path)))
                got = transplant(flat_params(jax.tree_util.tree_map(
                    np.asarray, trainer.final_state.params)))
            else:
                want = checkpoint.restore(path)["params"]
                got = trainer.final_state.model.state_dict()
            backbone = [k for k in want if k.startswith("breath_block.")]
            assert backbone and all(torch.equal(got[k], want[k])
                                    for k in backbone), side
            assert "lstm.input.i.weight" in got
            assert "linear_intermediate.weight" not in got
