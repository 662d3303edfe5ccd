"""A ``with_fft`` cnn_linear_2d run (3-channel images) through the port's
trainer against the JAX package's, as ``test_torch_2d_run_cnn.py``, with
the JAX trainer's test split built with the FFT channels: its own has
the flow image alone (``test_torch_2d_data.py`` pins that), which the
port's construction replaces.  Per-step losses within 1e-4, votes,
patient rows and AUCs equal."""
import pytest
import torch
from torch_2d_runs import (
    assert_meters_close,
    assert_votes_equal,
    flat_params,
    from_inits,
    narrow_backbones,
    overrides,
)

import deepards_tpu.data.img_dataset as jimg
import deepards_tpu.train.loop as jloop
import deepards_tpu_torch.train.loop as tloop
from deepards_tpu.config import Configuration as JaxConfiguration
from deepards_tpu_torch.config.config import Configuration
from deepards_tpu_torch.transplant import transplant

# parallel test workers share the cores: one torch thread each
torch.set_num_threads(1)


class _TestSplitWithFFT(jimg.ImgARDSDataset):
    """The JAX package's image dataset, its test split given the train
    split's FFT channels."""

    def __init__(self, raw_dataset, *args, **kwargs):
        if not raw_dataset.train:
            kwargs["add_fft"] = True
        super().__init__(raw_dataset, *args, **kwargs)


def test_fft_run_matches_jax_with_test_channels(synthetic_cohort, tmp_path):
    over = dict(network="cnn_linear_2d", with_fft=True, epochs=1)
    inits, channels = [], []
    create = jloop.create_train_state

    def recording(*args, **kw):
        state = create(*args, **kw)
        inits.append(transplant(flat_params(state.params)))
        return state

    get = tloop.Trainer.get_base_datasets

    def splits(self):
        train, test = get(self)
        channels.append((train.images.shape[1], test.images.shape[1]))
        return train, test

    with pytest.MonkeyPatch.context() as mp:
        narrow_backbones(mp)
        mp.setattr(jloop, "create_train_state", recording)
        mp.setattr(jimg, "ImgARDSDataset", _TestSplitWithFFT)
        jres = jloop.Trainer(JaxConfiguration(overrides=overrides(
            synthetic_cohort, tmp_path / "jax", **over)),
            verbose=False).train_and_test()
        from_inits(tloop.Trainer, inits, mp)
        mp.setattr(tloop.Trainer, "get_base_datasets", splits)
        port = tloop.Trainer(Configuration(overrides=overrides(
            synthetic_cohort, tmp_path / "port", **over)), device="cpu",
            verbose=False).train_and_test()
    assert channels == [(3, 3)]
    assert inits[0]["breath_block.conv0.weight"].shape[1] == 3
    assert_meters_close(port, jres, ("loss_epoch_", "test_loss_fold_"),
                        2 * 2)
    assert_votes_equal(port, jres, 2 * 1 * 4)
