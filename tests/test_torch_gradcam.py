"""GradCAM on the CPU against the JAX package: cnn_linear over densenet18
at S = 3 (numpy-drawn flax params carried over with ``transplant``,
float32).  The raw cams of the three variants, batched and per sequence,
within 1e-5 of JAX's; their uint8 normalizations equal where no value
lies within rounding of a step; ``upsample_cam`` within 1e-6 of
``jax.image.resize`` at up- and downsampling."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_configs_2_3_4 import random_params, windows

from deepards_tpu.explain import gradcam as jgradcam
from deepards_tpu.models import densenet1d as jdensenet
from deepards_tpu.models import heads as jheads
from deepards_tpu_torch.explain import gradcam
from deepards_tpu_torch.models import densenet1d, heads, recurrent
from deepards_tpu_torch.transplant import transplant

# parallel test workers share the cores: one torch thread each
torch.set_num_threads(1)

S, B, L = 3, 4, 224


@pytest.fixture(scope="module")
def models():
    x = windows(0, (B, S, 1, L))
    jmodel = jheads.CNNLinearNetwork(breath_block=jdensenet.densenet18())
    params = random_params(jmodel, 2, jnp.asarray(x), None, True)
    model = heads.CNNLinearNetwork(densenet1d.densenet18(), S)
    model.load_state_dict(transplant(params))
    return jmodel, params, model, x


def _uint8_equal(got, want, raw_scaled):
    """uint8 cams equal except where the JAX value times 255 lies within
    1e-3 of an integer (float32 rounding may put it on either side)."""
    near_step = np.abs(raw_scaled - np.round(raw_scaled)) < 1e-3
    assert np.array_equal(got[~near_step], want[~near_step])
    assert np.abs(got.astype(int) - want.astype(int)).max() <= 1


def _maxmin_scaled(cams):
    cams = np.maximum(cams, 0)
    span = cams.max(axis=-1, keepdims=True) - cams.min(axis=-1, keepdims=True)
    return (cams - cams.min(axis=-1, keepdims=True)) / np.where(
        span == 0, 1.0, span) * 255


def test_batched_cams_match_jax(models):
    jmodel, params, model, x = models
    targets = np.int32([0, 1, 1, 0])
    jcam = jgradcam.MaxMinNormCam(jmodel, params)
    want_raw, want_out = jcam._batch_cam(jnp.asarray(x), jnp.asarray(targets))
    cam = gradcam.MaxMinNormCam(model)
    raw, out = cam.read_cams_batch(x, targets)
    assert raw.shape == (B, S, 7)
    np.testing.assert_allclose(raw, np.asarray(want_raw), atol=1e-5, rtol=0)
    np.testing.assert_allclose(out, np.asarray(want_out)[:, 0], atol=1e-5,
                               rtol=0)
    got, _ = cam.generate_read_cams_batch(x, targets)
    want, _ = jcam.generate_read_cams_batch(x, targets)
    _uint8_equal(got, want, _maxmin_scaled(np.asarray(want_raw)))
    got, _ = gradcam.UnNormalizedCam(model).generate_read_cams_batch(
        x, targets)
    want, _ = jgradcam.UnNormalizedCam(jmodel, params).\
        generate_read_cams_batch(x, targets)
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=0)


def _jax_scaled(jplain, x, target, variant, whole=False):
    """What the JAX variant rounds to uint8, before rounding, from its own
    maps and gradients."""
    conv, grad, _ = jplain._grad_and_output(x, target)
    if whole:
        raw = (grad.mean(axis=(0, 2))[:, None] * conv.mean(axis=0)).sum(0)
        return _maxmin_scaled(raw[None])[0]
    raw = (grad.mean(axis=2)[:, :, None] * conv).sum(axis=1)
    if variant == "MaxMinNormCam":
        return _maxmin_scaled(raw)
    _, grad_o, _ = jplain._grad_and_output(x, (target + 1) % 2)
    other = np.maximum((grad_o.mean(axis=2)[:, :, None] * conv).sum(1), 0)
    raw = np.maximum(raw, 0)
    denom = raw + other
    return raw / np.where(denom == 0, 1.0, denom) * 255


@pytest.mark.parametrize("variant", ["MaxMinNormCam", "FracTotalNormCam",
                                     "UnNormalizedCam"])
def test_per_sequence_cams_match_jax(models, variant):
    """Each variant's per-read cams of one sequence, for each target, and
    (MaxMin, UnNormalized) the sequence's cam at its predicted class."""
    jmodel, params, model, x = models
    jcam = getattr(jgradcam, variant)(jmodel, params, record_grads=True)
    jplain = jgradcam.GradCam(jmodel, params)
    cam = getattr(gradcam, variant)(model, record_grads=True)
    for target in (0, 1):
        got, out = cam.generate_read_cam(x[1], target)
        want, want_out = jcam.generate_read_cam(x[1], target)
        np.testing.assert_allclose(out, want_out, atol=1e-5, rtol=0)
        if variant == "UnNormalizedCam":
            np.testing.assert_allclose(got, want, atol=1e-5, rtol=0)
        else:
            _uint8_equal(got, want, _jax_scaled(jplain, x[1], target,
                                                variant))
    if variant != "FracTotalNormCam":
        got, _ = cam.generate_cam(x[2])
        want, _ = jcam.generate_cam(x[2])
        if variant == "UnNormalizedCam":
            np.testing.assert_allclose(got, want, atol=1e-5, rtol=0)
        else:
            _uint8_equal(got, want, _jax_scaled(jplain, x[2], None, variant,
                                                whole=True))
    assert len(cam.grads) == len(jcam.grads)
    for g, w in zip(cam.grads, jcam.grads):
        np.testing.assert_allclose(g, w, atol=1e-5, rtol=0)


def test_raw_read_cam_matches_jax(models):
    """The per-sequence path's raw maps and gradients (what the three
    variants normalize) within 1e-5 (the maps, normalized features up to
    ~3, within 1e-5 of their size too)."""
    jmodel, params, model, x = models
    conv, grad, out = gradcam.GradCam(model)._grad_and_output(x[0], 1)
    jconv, jgrad, jout = jgradcam.GradCam(jmodel, params)._grad_and_output(
        x[0], 1)
    np.testing.assert_allclose(conv, jconv, atol=1e-5, rtol=1e-5)
    for a, b in ((grad, jgrad), (out, jout)):
        np.testing.assert_allclose(a, b, atol=1e-5, rtol=0)


def test_heads_of_more_linear_layers_are_refused():
    model = recurrent.CNNLSTMDoubleLinearNetwork(densenet1d.densenet18(), S)
    with pytest.raises(NotImplementedError, match="single-Linear"):
        gradcam.MaxMinNormCam(model)


@pytest.mark.parametrize("shape,target_len", [((7,), 224), ((3, 7), 224),
                                              ((2, 50), 20), ((5, 13), 13)])
def test_upsample_cam_matches_jax_resize(shape, target_len):
    cam = np.random.default_rng(1).uniform(0, 1, size=shape)
    got = gradcam.upsample_cam(cam, target_len)
    want = jgradcam.upsample_cam(cam, target_len)
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, atol=1e-6, rtol=0)
