"""The port's batch filters against scipy and against the JAX package's
(``deepards_tpu/data/pipeline.py``), on seeded (B, S, C, L) batches.

Tolerances, float32 input:
- ``sosfilt`` (one product with the impulse-response matrix, built in
  float64) against ``scipy.signal.sosfilt`` in float64: atol 2e-6 (read:
  at most 3.6e-7 over the six design branches); against the JAX package's
  float32 ``lax.scan`` cascade: atol 5e-5 (read: at most 1.3e-5, the
  scan's own float32 error against scipy);
- ``fft_resample`` against ``scipy.signal.resample`` in float64: atol
  2e-6 (read: at most 4.8e-7); against the JAX function when
  downsampling, the pipeline's use, the same (the JAX function does not
  halve the Nyquist bin when upsampling an even length, as scipy does);
- ``fft_band_filter`` against numpy in float64 and the JAX function: atol
  2e-6;
- ``transform_batch``, every combination of its five options, and
  ``BatchPipeline`` against the JAX package, on data up to ~10 after
  scaling: atol 2e-4 with the Butterworth filter in the chain (read: at
  most 6.5e-5, the JAX scan's float32 error), else 1e-5 (read: at most
  2.9e-6);
- the trainer's options (``--with-fft``, ``--only-fft --fft-real-only``,
  the Butterworth band, post-hoc downsampling with band filtering,
  ``--transforms``) give the JAX trainer's window cache exactly and its
  batch transforms to the tolerances above, and the model's input
  channels follow the cache.
"""
import itertools

import jax.numpy as jnp
import numpy as np
import pytest
import scipy.signal as ss
import torch

from deepards_tpu.data import pipeline as jpipeline
from deepards_tpu_torch.data import pipeline

torch.set_num_threads(1)

# (butter_low, butter_high): every branch of the reference's dispatch
BRANCHES = [(0.5, None), (0, 10.0), (None, 10.0), (1.0, 25), (1.0, 10.0),
            (5.0, None)]


def _batch(seed=0, shape=(3, 4, 1, 224)):
    return np.random.default_rng(seed).normal(size=shape).astype(np.float32)


@pytest.mark.parametrize("low,high", BRANCHES)
def test_sosfilt_matches_scipy_and_jax(low, high):
    sos = pipeline.design_butter_sos(low, high)
    np.testing.assert_array_equal(sos, jpipeline.design_butter_sos(low, high))
    x = _batch()
    got = pipeline.sosfilt(sos, torch.from_numpy(x)).numpy()
    exact = ss.sosfilt(sos.astype(np.float64), x.astype(np.float64), axis=-1)
    jax_out = np.asarray(jpipeline.sosfilt(jnp.asarray(sos), jnp.asarray(x)))
    np.testing.assert_allclose(got, exact, atol=2e-6, rtol=0)
    np.testing.assert_allclose(got, jax_out, atol=5e-5, rtol=0)


def test_no_filter_without_cutoffs():
    assert pipeline.design_butter_sos(None, None) is None


def test_sosfilt_matrix_is_the_impulse_response():
    sos = pipeline.design_butter_sos(1.0, 10.0)
    t = pipeline.sosfilt_matrix(sos, 16)
    assert np.array_equal(np.tril(t, -1), np.zeros((16, 16)))  # causal
    impulse = np.zeros(16)
    impulse[3] = 1.0
    np.testing.assert_allclose(impulse @ t, ss.sosfilt(sos, impulse),
                               atol=1e-12, rtol=0)


@pytest.mark.parametrize("new_len", [56, 112, 75, 224, 300, 301])
def test_fft_resample_matches_scipy_and_jax(new_len):
    x = _batch(1)
    got = pipeline.fft_resample(torch.from_numpy(x), new_len).numpy()
    exact = ss.resample(x.astype(np.float64), new_len, axis=-1)
    assert got.shape == x.shape[:-1] + (new_len,)
    np.testing.assert_allclose(got, exact, atol=2e-6, rtol=0)
    if new_len < x.shape[-1]:
        jax_out = np.asarray(jpipeline.fft_resample(jnp.asarray(x), new_len))
        np.testing.assert_allclose(got, jax_out, atol=2e-6, rtol=0)


@pytest.mark.parametrize("low,high", [(0.5, 5.0), (2.0, 20.0)])
def test_fft_band_filter_matches_numpy_and_jax(low, high):
    x = _batch(2)
    got = pipeline.fft_band_filter(torch.from_numpy(x), low, high).numpy()
    freqs = np.fft.fftfreq(x.shape[-1], d=0.02)
    keep = (np.abs(freqs) > low) & (np.abs(freqs) < high)
    exact = np.fft.ifft(np.fft.fft(x.astype(np.float64), axis=-1) * keep,
                        axis=-1).real
    jax_out = np.asarray(jpipeline.fft_band_filter(jnp.asarray(x), low, high))
    np.testing.assert_allclose(got, exact, atol=2e-6, rtol=0)
    np.testing.assert_allclose(got, jax_out, atol=2e-6, rtol=0)


@pytest.mark.parametrize(
    "is_padded,zero_mu,butter,post_hoc,band",
    list(itertools.product([False, True], repeat=5)))
def test_transform_batch_matches_jax(is_padded, zero_mu, butter, post_hoc,
                                     band):
    rng = np.random.default_rng(3)
    data = (rng.normal(size=(2, 3, 2, 224)) * 20 + 3).astype(np.float32)
    data[:, :, :, 150:] = 0.0  # padded tails
    mu = np.float32([3.0, -1.5])
    std = np.float32([20.0, 4.0])
    sos = pipeline.design_butter_sos(0.5, 10.0) if butter else None
    factor = 2.0 if post_hoc else None
    low, high = (0.5, 10.0) if band else (None, None)
    want = jpipeline.transform_batch(
        jnp.asarray(data), jnp.asarray(mu), jnp.asarray(std),
        jnp.asarray(sos) if butter else jnp.zeros((1, 6), jnp.float32),
        is_padded=is_padded, has_butter=butter,
        post_hoc_downsampling=factor, fft_low=low, fft_high=high,
        zero_mu=zero_mu)
    got = pipeline.transform_batch(
        torch.from_numpy(data), torch.from_numpy(mu), torch.from_numpy(std),
        is_padded=is_padded, zero_mu=zero_mu,
        sos_matrix=None if sos is None else torch.as_tensor(
            pipeline.sosfilt_matrix(sos, 224), dtype=torch.float32),
        post_hoc_downsampling=factor,
        band_mask=torch.as_tensor(pipeline.band_mask(224, low, high),
                                  dtype=torch.float32) if band else None)
    np.testing.assert_allclose(got.numpy(), np.asarray(want),
                               atol=2e-4 if butter else 1e-5, rtol=0)


class _Dataset:
    """The attributes a BatchPipeline reads."""

    def __init__(self, data, **options):
        self.cache = type("Cache", (), {"data": data})
        self.dataset_type = "padded_breath_by_breath"
        self.transforms = None
        self.butter_low = self.butter_high = None
        self.post_hoc_downsampling = None
        self.fft_filtering_low = self.fft_filtering_high = None
        self.__dict__.update(options)

    def scaling_for_current_fold(self):
        return np.float32([0.5]), np.float32([2.0])


@pytest.mark.parametrize("options", [
    {}, dict(butter_low=0.5), dict(butter_low=1.0, butter_high=10.0),
    dict(post_hoc_downsampling=4.0),
    dict(fft_filtering_low=1.0, fft_filtering_high=8.0),
    dict(transforms=object(), butter_high=5.0, post_hoc_downsampling=2.0,
         fft_filtering_low=0.5, fft_filtering_high=12.0),
])
def test_batch_pipeline_matches_jax(options):
    data = _batch(4, (2, 3, 1, 224)) * 10 + 1
    data[:, :, :, 200:] = 0.0
    ds = _Dataset(data, **options)
    want = jpipeline.BatchPipeline(ds)(jnp.asarray(data))
    got = pipeline.BatchPipeline(ds, "cpu")(torch.from_numpy(data))
    butter = options.get("butter_low") or options.get("butter_high")
    np.testing.assert_allclose(got.numpy(), np.asarray(want),
                               atol=2e-4 if butter else 1e-5, rtol=0)


_TRAINER_OPTIONS = {
    "with_fft": dict(with_fft=True),
    "only_fft-real": dict(only_fft=True, fft_real_only=True),
    "butter": dict(butter_low=0.5, butter_high=10.0),
    "post_hoc-band": dict(post_hoc_downsampling=2.0, fft_filtering_low=0.5,
                          fft_filtering_high=10.0),
    "transforms": dict(transforms=["ie_ww"]),
}


@pytest.mark.parametrize("name", sorted(_TRAINER_OPTIONS))
def test_trainer_options_reach_the_datasets_and_pipeline(synthetic_cohort,
                                                         tmp_path, name):
    """Each trainer option reaches the datasets (the FFT channels of the
    cache) and the batch transforms as the JAX trainer's does."""
    from deepards_tpu.config import Configuration as JaxConfiguration
    from deepards_tpu.train import loop as jloop
    from deepards_tpu_torch.config.config import Configuration
    from deepards_tpu_torch.train import loop as tloop

    conf = dict(data_path=synthetic_cohort["data_path"],
                cohort_file=synthetic_cohort["cohort_file"],
                experiment_num=1, network="cnn_linear",
                base_network="densenet18",
                dataset_type="unpadded_centered_sequences", n_sub_batches=4,
                kfolds=2, batch_size=8, dp_devices=1, seed=7,
                results_dir=str(tmp_path), **_TRAINER_OPTIONS[name])
    port = tloop.Trainer(Configuration(overrides=conf), device="cpu",
                         verbose=False)
    jax_trainer = jloop.Trainer(JaxConfiguration(overrides=conf),
                                verbose=False)
    (train, test), (jtrain, jtest) = (port.get_base_datasets(),
                                      jax_trainer.get_base_datasets())
    np.testing.assert_array_equal(train.cache.data, jtrain.cache.data)
    assert test.transforms is None and jtest.transforms is None
    assert callable(train.transforms) == callable(jtrain.transforms)
    channels = train.cache.data.shape[2]
    assert port.build_model().breath_block.conv0.in_channels == channels
    x = train.cache.data[:8]
    want = jpipeline.BatchPipeline(jtrain)(jnp.asarray(x))
    got = pipeline.BatchPipeline(train, "cpu")(torch.from_numpy(x))
    np.testing.assert_allclose(got.numpy(), np.asarray(want),
                               atol=2e-4 if name == "butter" else 1e-5,
                               rtol=0)
