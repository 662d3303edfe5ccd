"""Training over the remaining 1D backbones against the JAX package.

Three train steps (float32, dropout off, numpy-drawn params carried over
with ``transplant``, the 0.01 clamp and Nesterov SGD) of ``cnn_linear``
over vgg11_bn, senet18, se_resnext50_32x4d (narrowed to one block a
stage), unet and basic_cnn_ae, and of ``autoencoder`` (the MSE of the
reconstruction against the normalized input): losses within 1e-4, every
param within 1e-5 after each.  Then a whole 2-fold ``autoencoder`` run of
the port's trainer against the JAX trainer's, whose registry gives
``basic_cnn_ae`` the full ``AutoencoderCNN`` in this test only (its own
gives the encoder, over which the network cannot be built): per-step
train and test losses within 1e-4, the same meters."""
import numpy as np
import pytest
import torch
from test_torch_configs_2_3_4 import assert_train_steps_match_jax
from torch_2d_runs import assert_meters_close, flat_params, overrides

import deepards_tpu.models.registry as jregistry
import deepards_tpu.train.loop as jloop
import deepards_tpu_torch.train.loop as tloop
from deepards_tpu.config import Configuration as JaxConfiguration
from deepards_tpu.models import autoencoder_cnn as jae
from deepards_tpu.models import heads as jheads
from deepards_tpu.models import senet1d as jsenet
from deepards_tpu.models import unet1d as junet
from deepards_tpu.models import vgg1d as jvgg
from deepards_tpu_torch.config.config import Configuration
from deepards_tpu_torch.models import (
    autoencoder_cnn,
    heads,
    senet1d,
    unet1d,
    vgg1d,
)
from deepards_tpu_torch.transplant import transplant

# parallel test workers share the cores: one torch thread each
torch.set_num_threads(1)

S, B = 2, 4
NARROW_SE = dict(layers=(1, 1, 1, 1), groups=32, reduction=16,
                 dropout_p=None, inplanes=64, input_3x3=False,
                 downsample_kernel_size=1, downsample_padding=0)
BACKBONES = {
    "vgg11_bn": (jvgg.vgg11_bn, vgg1d.vgg11_bn),
    "senet18": (jsenet.senet18, senet1d.senet18),
    "se_resnext": (
        lambda: jsenet.SENet1D(block_cls=jsenet.SEResNeXtBottleneck,
                               **NARROW_SE),
        lambda: senet1d.SENet1D(block_cls=senet1d.SEResNeXtBottleneck,
                                **NARROW_SE)),
    "unet": (junet.UNet1DEncoder, unet1d.UNet1DEncoder),
    "basic_cnn_ae": (jae.AutoencoderCNNEncoder,
                     autoencoder_cnn.AutoencoderCNNEncoder),
}


@pytest.mark.parametrize("name", sorted(BACKBONES))
def test_cnn_linear_train_steps_match_jax(name):
    jbb, bb = BACKBONES[name]
    assert_train_steps_match_jax(
        jheads.CNNLinearNetwork(breath_block=jbb()),
        heads.CNNLinearNetwork(bb(), S), S, B, "sgd", "per_sample")


def test_autoencoder_train_steps_match_jax():
    assert_train_steps_match_jax(
        jheads.AutoencoderNetwork(breath_block=jae.AutoencoderCNN()),
        heads.AutoencoderNetwork(autoencoder_cnn.AutoencoderCNN()), S, B,
        "sgd", "autoencoder")


def test_autoencoder_run_matches_jax(synthetic_cohort, tmp_path):
    over = dict(network="autoencoder", base_network="basic_cnn_ae",
                dataset_type="unpadded_downsampled_autoencoder_sequences")
    inits = []
    create = jloop.create_train_state

    def recording(*args, **kw):
        state = create(*args, **kw)
        inits.append(transplant(flat_params(state.params)))
        return state

    with pytest.MonkeyPatch.context() as mp:
        mp.setitem(jregistry.BASE_NETWORKS, "basic_cnn_ae",
                   lambda conf: jae.AutoencoderCNN())
        mp.setattr(jloop, "create_train_state", recording)
        jres = jloop.make_trainer(JaxConfiguration(overrides=overrides(
            synthetic_cohort, tmp_path / "jax", **over)),
            verbose=False).train_and_test()
        runs = iter(inits)
        mp.setattr(tloop.Trainer, "init_model",
                   lambda self, model, fold: model.load_state_dict(
                       next(runs)))
        trainer = tloop.make_trainer(Configuration(overrides=overrides(
            synthetic_cohort, tmp_path / "port", **over)), device="cpu",
            verbose=False)
        port = trainer.train_and_test()
    assert len(inits) == 2
    # the train losses by epoch and fold, the test losses by epoch and
    # fold; no votes
    assert_meters_close(port, jres, ("loss", "test_loss"), 10)
    assert port.results == [] == jres.results.to_dict(orient="records")
    assert np.isfinite(port.get_meter("loss", 1).values).all()


def test_parallel_folds_refuses_the_autoencoder(synthetic_cohort, tmp_path):
    """As in the JAX package: the parallel-fold trainer takes standard
    classifiers only."""
    trainer = tloop.make_trainer(Configuration(overrides=overrides(
        synthetic_cohort, tmp_path, network="autoencoder",
        base_network="basic_cnn_ae", parallel_folds=True)), device="cpu",
        verbose=False)
    with pytest.raises(ValueError, match="classifier"):
        trainer.train_and_test()
