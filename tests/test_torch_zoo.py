"""The remaining 1D backbones against the JAX package: vgg (with and
without batch norm), the SE blocks of the senets, the UNet encoder and
the full UNet, the autoencoder and its encoder, the ``autoencoder``
network, ``cnn_linear`` over unet and ``protopnet`` over vgg11_bn, each
from numpy-drawn flax params carried over with ``transplant``: outputs
within 1e-4.  Also what the JAX package cannot build (the autoencoder
over its registry's encoder, a senet's ``conv_info``), its UNet encoder's
width mismatch, and the port's registry: every name of the JAX
package's two registries builds."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_configs_2_3_4 import (
    assert_round_trip,
    jit_apply,
    random_params,
    windows,
)

from deepards_tpu.models import autoencoder_cnn as jae
from deepards_tpu.models import heads as jheads
from deepards_tpu.models import protopnet1d as jprotopnet
from deepards_tpu.models import registry as jregistry
from deepards_tpu.models import senet1d as jsenet
from deepards_tpu.models import unet1d as junet
from deepards_tpu.models import vgg1d as jvgg
from deepards_tpu_torch.models import (
    autoencoder_cnn,
    heads,
    senet1d,
    unet1d,
    vgg1d,
)
from deepards_tpu_torch.models.layers import bn_row_mask
from deepards_tpu_torch.models.registry import (
    BASE_NETWORKS,
    NETWORK_MAP,
    get_base_network,
    get_network_spec,
    two_dim_base_network,
)
from deepards_tpu_torch.transplant import transplant

# parallel test workers share the cores: one torch thread each
torch.set_num_threads(1)

L = 224
ATOL = 1e-4


def _t(x):
    return torch.from_numpy(np.asarray(x))


def assert_backbone_matches(jmodel, model, x, seed=1, rows=None):
    """``model`` with ``jmodel``'s numpy-drawn params gives its outputs on
    ``x`` (N, C, L) within ATOL, under the row mask ``rows`` if given."""
    params = random_params(jmodel, seed, jnp.asarray(x), True)
    want = jit_apply(jmodel, True)(params, jnp.asarray(x), rows)
    assert_round_trip(params, model)
    with torch.no_grad(), bn_row_mask(None if rows is None else _t(rows)):
        got = model(_t(x), True).numpy()
    assert got.shape == want.shape
    np.testing.assert_allclose(got, np.asarray(want), atol=ATOL, rtol=0)
    return params


@pytest.mark.parametrize("name", ["vgg11", "vgg11_bn", "vgg13", "vgg13_bn"])
def test_vgg_matches_flax(name):
    rows = np.float32([1, 1, 1, 1, 0]) if name.endswith("_bn") else None
    assert_backbone_matches(getattr(jvgg, name)(), getattr(vgg1d, name)(),
                            windows(0, (5, 1, L)), rows=rows)
    assert getattr(vgg1d, name)().n_out_filters == 512 * 7


SE_BLOCKS = [("SEBasicBlock", 64), ("SEBottleneck", 64),
             ("SEResNetBottleneck", 1), ("SEResNeXtBottleneck", 32)]


@pytest.mark.parametrize("block,groups", SE_BLOCKS)
@pytest.mark.parametrize("stem_3x3", [True, False])
def test_se_blocks_match_flax(block, groups, stem_3x3):
    """Each SE block, with its grouped convs and downsamples, in a senet
    of one block a stage, under either stem; the ceil-mode pool."""
    kw = dict(layers=(1, 1, 1, 1), groups=groups, reduction=16,
              dropout_p=None, inplanes=128 if stem_3x3 else 64,
              input_3x3=stem_3x3,
              downsample_kernel_size=3 if stem_3x3 else 1,
              downsample_padding=1 if stem_3x3 else 0)
    jmodel = jsenet.SENet1D(block_cls=getattr(jsenet, block), **kw)
    model = senet1d.SENet1D(block_cls=getattr(senet1d, block), **kw)
    assert_backbone_matches(jmodel, model, windows(1, (4, 1, L)),
                            rows=np.float32([1, 1, 0, 1]))
    assert model.n_out_filters == jmodel.n_out_filters


SENETS = ("senet18", "senet154", "se_resnet18", "se_resnet50",
          "se_resnet101", "se_resnet152", "se_resnext50_32x4d",
          "se_resnext101_32x4d")
SENET_FIELDS = ("layers", "groups", "reduction", "dropout_p", "inplanes",
                "input_3x3", "downsample_kernel_size", "downsample_padding")


@pytest.mark.parametrize("name", SENETS)
def test_senet_constructors_match_jax(name):
    """Each of the eight constructors has the JAX one's block, stage
    depths, groups, reduction, dropout and stem."""
    jmodel, model = getattr(jsenet, name)(), getattr(senet1d, name)()
    assert type(model.blocks[0]).__name__ == jmodel.block_cls.__name__
    for field in SENET_FIELDS:
        want = getattr(jmodel, field)
        assert getattr(model, field) == (tuple(want) if field == "layers"
                                         else want), field
    assert model.n_out_filters == jmodel.n_out_filters
    assert len(model.blocks) == sum(jmodel.layers)


def test_senet_dropout_only_where_set():
    """senet18's features drop out in training (its ``dropout_p`` 0.2);
    se_resnet18's are the same with dropout on or off."""
    x = torch.from_numpy(windows(2, (3, 1, L)))
    for name, drops in (("senet18", True), ("se_resnet18", False)):
        model = getattr(senet1d, name)().reset_parameters(
            torch.Generator().manual_seed(0))
        with torch.no_grad():
            off = model(x, True)
            on = model(x, False, torch.Generator().manual_seed(1))
        assert (not torch.equal(on, off)) == drops, name


def test_unet_matches_flax():
    x = windows(3, (3, 1, L))
    assert_backbone_matches(junet.UNet1DEncoder(), unet1d.UNet1DEncoder(), x)
    assert_backbone_matches(junet.UNet1D(), unet1d.UNet1D(), x, seed=2)
    x = jnp.asarray(windows(4, (2, 5, 3)))
    up = np.asarray(junet.linear_upsample(x))
    got = unet1d.linear_upsample(_t(np.asarray(x)).transpose(1, 2))
    np.testing.assert_allclose(got.transpose(1, 2).numpy(), up, atol=1e-6,
                               rtol=0)


def test_unet_encoder_width():
    """The JAX encoder reports 512 features and returns 28 x 512 a window;
    the JAX cnn_linear over it sizes its Dense from what it reads, (S *
    14,336, 2).  The port's encoder reports its real width, and its
    cnn_linear over unet is the JAX one."""
    s = 2
    x = windows(5, (2, s, 1, L))
    jenc = junet.UNet1DEncoder()
    assert jenc.n_out_filters == 512
    enc_params = random_params(jenc, 0, jnp.asarray(x[0]), True)
    width = jenc.apply({"params": enc_params}, jnp.asarray(x[0]),
                       True).shape[1]
    assert width == 28 * 512 == unet1d.UNet1DEncoder().n_out_filters
    jmodel = jheads.CNNLinearNetwork(breath_block=jenc)
    params = random_params(jmodel, 6, jnp.asarray(x), None, True)
    assert params["Dense_0"]["kernel"].shape == (s * 28 * 512, 2)
    want = jit_apply(jmodel, True)(params, jnp.asarray(x), None, None)
    model = heads.CNNLinearNetwork(unet1d.UNet1DEncoder(), s)
    assert_round_trip(params, model)
    with torch.no_grad():
        got = model(_t(x), True).numpy()
    np.testing.assert_allclose(got, np.asarray(want), atol=ATOL, rtol=0)


def test_autoencoder_matches_flax():
    x = windows(7, (4, 1, L))
    rows = np.float32([1, 1, 1, 0])
    assert_backbone_matches(jae.AutoencoderCNNEncoder(),
                            autoencoder_cnn.AutoencoderCNNEncoder(), x,
                            rows=rows)
    assert_backbone_matches(jae.AutoencoderCNN(),
                            autoencoder_cnn.AutoencoderCNN(), x, seed=3,
                            rows=rows)


def test_autoencoder_pool_ties_go_to_the_first():
    """The pool's one-hot and its gradient on ties, against the JAX
    functions; and the whole autoencoder on a constant input, where every
    pool window ties (each norm's output is its bias)."""
    x = np.float32([[[1, 1, 2, 0, -1, 3, 5, 5]], [[0, 0, 0, 0, 2, 2, 1, 4]]])
    jx = jnp.asarray(x.transpose(0, 2, 1))
    jpooled, jonehot = jae.max_pool_with_argmax(jx)
    pooled, onehot = autoencoder_cnn.max_pool_with_argmax(_t(x))
    np.testing.assert_array_equal(pooled.numpy(),
                                  np.asarray(jpooled).transpose(0, 2, 1))
    np.testing.assert_array_equal(
        onehot.numpy(), np.asarray(jonehot).transpose(0, 3, 1, 2))
    assert onehot[0, 0, 0].tolist() == [1.0, 0.0]
    unpooled = autoencoder_cnn.max_unpool(pooled, onehot)
    np.testing.assert_array_equal(unpooled.numpy(), np.asarray(
        jae.max_unpool(jpooled, jonehot)).transpose(0, 2, 1))

    def jloss(v):
        p, _ = jae.max_pool_with_argmax(v)
        return (p * jnp.arange(1.0, 1.0 + p.size).reshape(p.shape)).sum()

    jgrad = np.asarray(jax.grad(jloss)(jx)).transpose(0, 2, 1)
    xt = _t(x).requires_grad_()
    p, _ = autoencoder_cnn.max_pool_with_argmax(xt)
    (p * torch.arange(1.0, 1.0 + p.numel()).reshape(p.shape)).sum().backward()
    np.testing.assert_allclose(xt.grad.numpy(), jgrad, atol=0, rtol=0)
    # zero-padded windows (as padded breaths are): their tails tie in
    # every pool window of every stage
    padded = windows(12, (3, 1, L))
    padded[..., L // 2:] = 0.0
    assert_backbone_matches(jae.AutoencoderCNN(),
                            autoencoder_cnn.AutoencoderCNN(), padded, seed=4,
                            rows=np.ones(3, np.float32))


def test_autoencoder_network_matches_flax():
    """``autoencoder`` over the full AutoencoderCNN reconstructs (B, S, C,
    L); the JAX network over its registry's encoder cannot be built."""
    x = windows(8, (2, 3, 1, L))
    # the train and eval steps' row mask (all real rows) scoped, as the
    # JAX trainer scopes it; jitted without one, the JAX autoencoder's
    # output departs from its own eager output
    rows = np.ones(6, np.float32)
    jmodel = jheads.AutoencoderNetwork(breath_block=jae.AutoencoderCNN())
    params = random_params(jmodel, 9, jnp.asarray(x), None, True)
    want = jit_apply(jmodel, True)(params, jnp.asarray(x), rows, None)
    conf = {"base_network": "basic_cnn_ae"}
    model = get_network_spec("autoencoder").build(
        conf, get_base_network(conf), 3)
    assert_round_trip(params, model)
    with torch.no_grad(), bn_row_mask(_t(rows)):
        got = model(_t(x), True).numpy()
    assert got.shape == x.shape
    np.testing.assert_allclose(got, np.asarray(want), atol=ATOL, rtol=0)
    broken = jheads.AutoencoderNetwork(
        breath_block=jregistry.BASE_NETWORKS["basic_cnn_ae"](None))
    with pytest.raises(TypeError, match="reshape"):
        broken.init(jax.random.PRNGKey(0), jnp.asarray(x), None, True)


@pytest.mark.parametrize("base", ["densenet18", "unet", "vgg11"])
def test_autoencoder_refused_over_other_base_networks(base):
    conf = {"base_network": base}
    with pytest.raises(ValueError, match="basic_cnn_ae"):
        get_network_spec("autoencoder").build(conf, get_base_network(conf),
                                              3)


def test_protopnet_over_vgg11_bn_matches_flax():
    """The add-on stack halves from 512 * 7 while its first conv reads the
    map's 512 channels, as flax sizes it; logits, distances and the
    receptive fields as the JAX network's."""
    s = 2
    x = windows(10, (2, s, 1, L))
    jmodel = jprotopnet.construct_ppnet(jvgg.vgg11_bn(), sub_batch_size=s,
                                        n_prototypes=2)
    params = random_params(jmodel, 11, jnp.asarray(x), None, True)
    params["prototype_vectors"] = np.random.default_rng(12).uniform(
        size=params["prototype_vectors"].shape).astype(np.float32)
    want_logits, want_d = jit_apply(jmodel, True)(params, jnp.asarray(x),
                                                  None, None)
    conf = {"base_network": "vgg11_bn", "n_prototypes": 2}
    model = get_network_spec("protopnet").build(
        conf, get_base_network(conf), s)
    model.load_state_dict(transplant(params))
    with torch.no_grad():
        logits, min_d = model(_t(x), True)
    np.testing.assert_allclose(logits.numpy(), np.asarray(want_logits),
                               atol=ATOL, rtol=0)
    np.testing.assert_allclose(min_d.numpy(), np.asarray(want_d), atol=ATOL,
                               rtol=0)
    assert model.proto_layer_rf_info() == jmodel.proto_layer_rf_info()


@pytest.mark.parametrize("base", ["senet18", "se_resnext50_32x4d"])
def test_protopnet_over_senet_refused(base):
    """A senet has no receptive-field arithmetic: its conv_info raises in
    both packages, and the port refuses protopnet over it."""
    with pytest.raises(NotImplementedError, match="receptive-field"):
        jregistry.BASE_NETWORKS[base](None).conv_info()
    conf = {"base_network": base}
    with pytest.raises(NotImplementedError, match="receptive-field"):
        get_network_spec("protopnet").build(conf, get_base_network(conf), 2)


def test_registries_hold_every_jax_name():
    assert set(BASE_NETWORKS) == set(jregistry.BASE_NETWORKS)
    assert set(NETWORK_MAP) == set(jregistry.NETWORK_MAP)


@pytest.mark.parametrize("name", sorted(jregistry.BASE_NETWORKS))
def test_every_jax_base_network_builds(name):
    bb = get_base_network({"base_network": name}, 1)
    assert isinstance(bb, torch.nn.Module) and bb.n_out_filters > 0


# a backbone each network builds over: its own family for the 2D ones,
# the autoencoder's own encoder
BUILD_BASE = {"autoencoder": "basic_cnn_ae"}
SPEC_FIELDS = ("target_mode", "kind", "expand_obs_idx", "uses_metadata",
               "stateful_lstm", "super_batch", "eval_dropout_off", "trainer",
               "two_dim")


@pytest.mark.parametrize("name", sorted(jregistry.NETWORK_MAP))
def test_every_jax_network_builds(name):
    """Each network of the JAX registry builds in the port, with the JAX
    spec's fields (the ProtoPNet networks evaluate with dropout off in
    the port, as their trainer does)."""
    spec = get_network_spec(name)
    want = jregistry.get_network_spec(name)
    for field in SPEC_FIELDS:
        if field == "eval_dropout_off" and spec.trainer == "protopnet":
            continue
        assert getattr(spec, field) == getattr(want, field), field
    base = BUILD_BASE.get(name, "densenet18")
    if spec.two_dim:
        base = two_dim_base_network(spec, base)
    conf = {"base_network": base}
    model = spec.build(conf, get_base_network(conf, 1), 4, 0)
    assert sum(p.numel() for p in model.parameters()) > 0
