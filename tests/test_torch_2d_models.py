"""The 2D networks' modules against the JAX package.

Numpy-drawn flax params (``random_params``) carried over with
``transplant`` ((H, W, Cin, Cout) kernels to (Cout, Cin, H, W)), the same
numpy inputs, float32, dropout off (the 2D densenets have none):

- ``BatchStatNorm`` over (N, C, H, W), with and without a row mask over
  the N images: 1e-6;
- densenet18_2d, densenet121_2d and densenet18_2x1d (narrow: growth 8,
  16 initial features) at ``block_kernel_size`` 3 and 7 under
  ``CNNLinearNetwork2D``, ``PPNet2D`` logits and min distances, the
  ``RowBandDetector``'s row logits: 1e-4;
- ``row_labels_from_boxes``, ``extract_bands`` and ``band_iou``: equal.

Each tolerance check fails a planted fault: the norm's mask ignored, a
(k, k) kernel where (k, 1) is due.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import traverse_util
from test_torch_configs_2_3_4 import jit_apply, random_params

from deepards_tpu.models import densenet2d as jdensenet
from deepards_tpu.models import detection2d as jdetection
from deepards_tpu.models import protopnet2d as jprotopnet
from deepards_tpu.models import registry as jregistry
from deepards_tpu.models.layers import BatchStatNorm as JaxNorm
from deepards_tpu.models.layers import bn_row_mask as jax_bn_row_mask
from deepards_tpu.train.detector_trainer import band_iou as jax_band_iou
from deepards_tpu_torch.models import densenet2d, detection2d, protopnet2d
from deepards_tpu_torch.models.layers import BatchStatNorm, bn_row_mask
from deepards_tpu_torch.models.registry import (
    BASE_NETWORKS,
    NETWORK_MAP,
    get_base_network,
    get_network_spec,
    two_dim_base_network,
)
from deepards_tpu_torch.train.detector_trainer import band_iou
from deepards_tpu_torch.transplant import transplant

torch.set_num_threads(1)

NARROW = dict(growth_rate=8, num_init_features=16)


def _images(seed, shape):
    return np.random.default_rng(seed).normal(size=shape).astype(np.float32)


def _port_norm(params, x, mask):
    norm = BatchStatNorm(x.shape[1])
    norm.load_state_dict(transplant({"scale": params["scale"],
                                     "bias": params["bias"]}))
    with torch.no_grad(), bn_row_mask(None if mask is None
                                      else torch.from_numpy(mask)):
        return norm(torch.from_numpy(x)).numpy()


@pytest.mark.parametrize("masked", [False, True], ids=["batch", "row_mask"])
def test_batch_stat_norm_2d_matches_flax(masked):
    x = _images(0, (5, 6, 9, 11)) * 3 + 1
    mask = np.float32([1, 1, 0, 1, 0]) if masked else None
    jnorm = JaxNorm()
    nhwc = jnp.asarray(x.transpose(0, 2, 3, 1))
    params = jax.tree_util.tree_map(
        np.asarray, {"scale": 1 + 0.1 * _images(1, (6,)),
                     "bias": 0.1 * _images(2, (6,))})
    with jax_bn_row_mask(None if mask is None else jnp.asarray(mask)):
        want = np.asarray(jnorm.apply({"params": params}, nhwc)).transpose(
            0, 3, 1, 2)
    got = _port_norm(params, x, mask)
    np.testing.assert_allclose(got, want, atol=1e-6, rtol=0)
    if masked:
        # the real images normalize as a batch of them alone
        alone = _port_norm(params, x[mask > 0], None)
        np.testing.assert_allclose(got[mask > 0], alone, atol=1e-6, rtol=0)
        # planted: the mask ignored
        with pytest.raises(AssertionError):
            np.testing.assert_allclose(_port_norm(params, x, None), want,
                                       atol=1e-6, rtol=0)


def _flax_pair(jmodel, seed, x):
    params = random_params(jmodel, seed, jnp.asarray(x), None, True)
    want = jit_apply(jmodel, None, True)(params, jnp.asarray(x), None)
    return params, want


def _logits(model, x):
    with torch.no_grad():
        return model(torch.from_numpy(x), True)


@pytest.mark.parametrize("blocks,kernel", [
    ((2, 2, 2, 2), (3, 3)), ((2, 2, 2, 2), (7, 7)),
    ((6, 12, 24, 16), (3, 3)), ((6, 12, 24, 16), (7, 7)),
    ((2, 2, 2, 2), (3, 1)), ((2, 2, 2, 2), (7, 1))],
    ids=["18_k3", "18_k7", "121_k3", "121_k7", "18_2x1d_k3", "18_2x1d_k7"])
def test_cnn_linear_2d_matches_flax(blocks, kernel):
    x = _images(3, (3, 2, 64, 64))
    jmodel = jdensenet.CNNLinearNetwork2D(breath_block=jdensenet.DenseNet2D(
        block_config=blocks, block_kernel=kernel, **NARROW))
    params, want = _flax_pair(jmodel, 4, x)
    state = transplant(params)
    model = densenet2d.CNNLinearNetwork2D(densenet2d.DenseNet2D(
        block_config=blocks, block_kernel=kernel, in_channels=2, **NARROW))
    assert set(state) == set(model.state_dict())
    flat = traverse_util.flatten_dict(params, sep="/")
    assert len(state) == len(flat)
    model.load_state_dict(state)
    got = _logits(model, x).numpy()
    assert got.shape == (3, 2)
    np.testing.assert_allclose(got, np.asarray(want), atol=1e-4, rtol=0)
    if kernel[1] == 1 and kernel[0] > 1:
        # planted: a (k, k) kernel where (k, 1) is due, each of its
        # columns the (k, 1) weights
        square = densenet2d.CNNLinearNetwork2D(densenet2d.DenseNet2D(
            block_config=blocks, block_kernel=(kernel[0],) * 2,
            in_channels=2, **NARROW))
        planted = {k: v.expand_as(square.state_dict()[k]).clone()
                   for k, v in state.items()}
        square.load_state_dict(planted)
        with pytest.raises(AssertionError):
            np.testing.assert_allclose(_logits(square, x).numpy(),
                                       np.asarray(want), atol=1e-4, rtol=0)


def test_ppnet_2d_matches_flax():
    x = _images(5, (3, 1, 64, 64))
    jmodel = jprotopnet.construct_ppnet_2d(
        jdensenet.DenseNet2D(**NARROW), n_prototypes=3)
    params, (want_logits, want_min) = _flax_pair(jmodel, 6, x)
    model = protopnet2d.construct_ppnet_2d(densenet2d.DenseNet2D(**NARROW),
                                           n_prototypes=3)
    model.load_state_dict(transplant(params))
    logits, min_d = _logits(model, x)
    assert min_d.shape == (3, 6)
    np.testing.assert_allclose(logits.numpy(), np.asarray(want_logits),
                               atol=1e-4, rtol=0)
    np.testing.assert_allclose(min_d.numpy(), np.asarray(want_min),
                               atol=1e-4, rtol=0)
    # the push's layouts: patches (N, H', W', C), distances (N, H'*W', P),
    # positions row-major as the JAX package's
    jfeats, jdists = jax.jit(lambda p, v: jmodel.apply(
        {"params": p}, v, None, True, method=jmodel.push_forward))(
            params, jnp.asarray(x))
    with torch.no_grad():
        feats, dists = model.push_forward(torch.from_numpy(x))
    np.testing.assert_allclose(feats.numpy(), np.asarray(jfeats), atol=1e-4,
                               rtol=0)
    np.testing.assert_allclose(dists.numpy(), np.asarray(jdists), atol=1e-4,
                               rtol=0)
    init = protopnet2d.construct_ppnet_2d(
        densenet2d.DenseNet2D(**NARROW), n_prototypes=3).reset_parameters(
            torch.Generator().manual_seed(0))
    assert init.last_layer.weight[0].tolist() == [1.0] * 3 + [-0.5] * 3


def test_row_band_detector_matches_flax():
    x = _images(7, (2, 1, 224, 224))
    jmodel = jdetection.RowBandDetector(
        breath_block=jdensenet.DenseNet2D(**NARROW))
    params, want = _flax_pair(jmodel, 8, x)
    model = detection2d.RowBandDetector(densenet2d.DenseNet2D(**NARROW))
    model.load_state_dict(transplant(params))
    got = _logits(model, x).numpy()
    assert got.shape == (2, 224, 2)
    np.testing.assert_allclose(got, np.asarray(want), atol=1e-4, rtol=0)


def test_bands_and_iou_match_jax():
    rng = np.random.default_rng(9)
    starts = rng.integers(10, 150, size=6)
    boxes = np.array([[[0, 0, 224, a], [0, a, 224, a + 50],
                       [0, a + 50, 224, 224]] for a in starts], np.float32)
    labels = np.stack([starts % 2, 1 - starts % 2, starts % 2], axis=1)
    rows = detection2d.row_labels_from_boxes(boxes, labels)
    np.testing.assert_array_equal(
        rows, jdetection.row_labels_from_boxes(boxes, labels))
    logits = (rng.normal(size=(6, 224, 2)) + 3 * (2 * rows - 1)).astype(
        np.float32)
    for threshold in (0.0, 0.5):
        got = detection2d.extract_bands(logits, threshold)
        want = jdetection.extract_bands(logits, threshold)
        assert [[(b, lab) for b, lab, _ in img] for img in got] == \
            [[(b, lab) for b, lab, _ in img] for img in want]
        np.testing.assert_allclose(
            [s for img in got for _, _, s in img],
            [s for img in want for _, _, s in img], rtol=1e-6)
    bands = detection2d.extract_bands(logits, 0.0)
    for i in range(6):
        assert band_iou(bands[i], boxes[i], labels[i]) == jax_band_iou(
            bands[i], boxes[i], labels[i])
    assert 0.0 < band_iou(bands[0], boxes[0], labels[0]) <= 1.0
    assert band_iou([], boxes[0], labels[0]) == 0.0


def test_registry_2d_entries():
    """No 2D name is left unported; the 2D specs and backbones as the JAX
    package's, the base network suffixed by the network's family."""
    two_dim = [n for n in (*jregistry.BASE_NETWORKS, *jregistry.NETWORK_MAP)
               if "2d" in n or "2x1d" in n]
    assert two_dim and all(n in BASE_NETWORKS or n in NETWORK_MAP
                           for n in two_dim)
    for name, kind, trainer in (
            ("cnn_linear_2d", "classifier", "standard"),
            ("cnn_linear_2x1d", "classifier", "standard"),
            ("protopnet_2d", "classifier", "protopnet"),
            ("retinanet_2d", "detector", "standard"),
            ("retinanet_2x1d", "detector", "standard"),
            ("faster_rcnn_2d", "detector", "standard")):
        spec = get_network_spec(name)
        assert (spec.kind, spec.trainer, spec.two_dim) == (kind, trainer,
                                                           True)
    base = two_dim_base_network(get_network_spec("cnn_linear_2x1d"),
                                "densenet18")
    assert base == "densenet18_2x1d"
    bb = get_base_network({"base_network": base, "block_kernel_size": 11},
                          in_channels=3)
    assert bb.block_kernel == (11, 1) and bb.conv0.in_channels == 3
    assert bb.dense_layers[0].conv2.padding == (5, 0)
    assert two_dim_base_network(get_network_spec("retinanet_2d"),
                                "densenet121") == "densenet121_2d"
