"""The transformer core (``deepards_tpu_torch/models/transformer.py``)
against the JAX package's flax modules
(``deepards_tpu/models/transformer.py``).

Parameters are numpy draws in the flax trees' shapes, carried over with
``transplant`` (``test_torch_configs_2_3_4.random_params``); dropout off.
Float32 within 1e-5: ``LayerNorm`` alone (flax's eps 1e-6, which
torch's default LayerNorm does not share, and its variance clipped at 0),
attention with and without a key mask, a block, and a 2-block
transformer.  A bfloat16 LayerNorm and forward within 2e-2 absolute
and relative (bf16 rounds params and activations at 8 bits of mantissa,
and the outputs are bf16 themselves, one rounding 2^-8 of their size
apart at most; the statistics, scores and softmax stay float32 on both
sides).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import linen as flax_nn
from test_torch_configs_2_3_4 import random_params, windows

from deepards_tpu.models import transformer as jtransformer
from deepards_tpu_torch.models import transformer
from deepards_tpu_torch.transplant import transplant

# parallel test workers share the cores: one torch thread each
torch.set_num_threads(1)

B, S, F, H = 3, 5, 24, 16
BF16_ATOL = 2e-2


def _t(x):
    return torch.from_numpy(np.asarray(x))


def _port(params, module):
    holder = torch.nn.ModuleDict({"transformer": module})
    holder.load_state_dict(transplant({"Transformer_0": params}))
    return module


def _mask():
    mask = np.ones((B, S), bool)
    mask[0, 3:] = False
    mask[2, 1:] = False  # one valid key
    return mask


def test_layer_norm_matches_flax():
    """Rows of small variance (~2.5e-5), where flax's eps 1e-6 and torch's
    default 1e-5 part, and a constant row (variance 0)."""
    x = windows(0, (B, S, F)) * 0.005 + 0.01
    x[1, 2] = 3.0
    jnorm = flax_nn.LayerNorm()
    params = {"scale": 1 + 0.1 * windows(1, (F,)),
              "bias": 0.1 * windows(2, (F,))}
    want = np.asarray(jnorm.apply({"params": params}, jnp.asarray(x)))
    norm = transformer.LayerNorm(F)
    norm.load_state_dict({"weight": _t(params["scale"]),
                          "bias": _t(params["bias"])})
    with torch.no_grad():
        got = norm(_t(x)).numpy()
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=0)
    np.testing.assert_allclose(got[1, 2], params["bias"], atol=1e-6, rtol=0)
    torch_default = torch.nn.functional.layer_norm(
        _t(x), (F,), _t(params["scale"]), _t(params["bias"])).numpy()
    assert np.abs(torch_default - want).max() > 1e-2


def test_layer_norm_bf16_keeps_float32_statistics():
    x = windows(3, (B, S, F)) * 4 + 2
    norm = transformer.LayerNorm(F).to(torch.bfloat16)
    with torch.no_grad():
        got = norm(_t(x).to(torch.bfloat16))
    want = np.asarray(flax_nn.LayerNorm().apply(
        {"params": {"scale": jnp.ones(F, jnp.bfloat16),
                    "bias": jnp.zeros(F, jnp.bfloat16)}},
        jnp.asarray(x, jnp.bfloat16)))
    assert got.dtype == torch.bfloat16 and want.dtype == jnp.bfloat16
    np.testing.assert_allclose(got.float().numpy(), want.astype(np.float32),
                               atol=BF16_ATOL, rtol=BF16_ATOL)


@pytest.mark.parametrize("masked", [False, True])
def test_attention_matches_flax(masked):
    x = windows(4, (B, S, F))
    mask = _mask() if masked else None
    jatt = jtransformer.MultiHeadAttention(F, H, 4)
    params = random_params(jatt, 5, jnp.asarray(x), jnp.asarray(x),
                           jnp.asarray(x))
    jmask = None if mask is None else jnp.asarray(mask)
    want = jax.jit(lambda p, v, m: jatt.apply({"params": p}, v, v, v, m))(
        params, jnp.asarray(x), jmask)
    att = transformer.MultiHeadAttention(F, H, 4)
    state = transplant(
        {"Transformer_0": {"Block_0": {"MultiHeadAttention_0": params}}})
    prefix = "transformer.blocks.0.attention."
    att.load_state_dict({k[len(prefix):]: v for k, v in state.items()})
    tmask = None if mask is None else _t(mask)
    with torch.no_grad():
        got = att(_t(x), _t(x), _t(x), tmask).numpy()
    np.testing.assert_allclose(got, np.asarray(want), atol=1e-5, rtol=0)
    if masked:
        # a masked key changes nothing: perturb the masked positions
        x2 = x.copy()
        x2[0, 3:] += 5.0
        with torch.no_grad():
            again = att(_t(x), _t(x2), _t(x2), tmask).numpy()
        np.testing.assert_array_equal(again[0], got[0])


@pytest.mark.parametrize("masked", [False, True])
def test_transformer_matches_flax(masked):
    """Two blocks; the second residual adds each block's input."""
    x = windows(6, (B, S, F))
    mask = _mask() if masked else None
    jmodel = jtransformer.Transformer(F, H, num_blocks=2, num_heads=4)
    jmask = None if mask is None else jnp.asarray(mask)
    params = random_params(jmodel, 7, jnp.asarray(x), True, jmask)
    want = jax.jit(lambda p, v, m: jmodel.apply(
        {"params": p}, v, True, mask=m))(params, jnp.asarray(x), jmask)
    model = _port(params, transformer.Transformer(F, H, 2, 4))
    with torch.no_grad():
        got = model(_t(x), True, None,
                    None if mask is None else _t(mask)).numpy()
    np.testing.assert_allclose(got, np.asarray(want), atol=1e-5, rtol=0)


def test_transformer_bf16_forward():
    x = windows(8, (B, S, F))
    jmodel = jtransformer.Transformer(F, H, num_blocks=2, num_heads=4)
    params = random_params(jmodel, 9, jnp.asarray(x), True)
    bf16 = jax.tree_util.tree_map(lambda a: jnp.asarray(a, jnp.bfloat16),
                                  params)
    want = jmodel.apply({"params": bf16}, jnp.asarray(x, jnp.bfloat16), True)
    model = _port(params, transformer.Transformer(F, H, 2, 4))
    cast = {k: v.to(torch.bfloat16) for k, v in model.named_parameters()}
    with torch.no_grad():
        got = torch.func.functional_call(
            model, cast, (_t(x).to(torch.bfloat16), True))
    assert got.dtype == torch.bfloat16 and want.dtype == jnp.bfloat16
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32),
                               atol=BF16_ATOL, rtol=BF16_ATOL)


def test_block_dropout_draws_from_the_generator():
    """Dropout 0.2 after the attention and the feed-forward, drawn from
    the generator passed in: the same seed gives the same output, another
    seed another; deterministic gives the dropout-free output."""
    x = _t(windows(10, (B, S, F)))
    model = transformer.Transformer(F, H, 1, 4).reset_parameters(
        torch.Generator().manual_seed(0))
    with torch.no_grad():
        a = model(x, False, torch.Generator().manual_seed(1))
        b = model(x, False, torch.Generator().manual_seed(1))
        c = model(x, False, torch.Generator().manual_seed(2))
        d = model(x, True)
    assert torch.equal(a, b) and not torch.equal(a, c)
    assert not torch.equal(a, d)
    assert model.blocks[0].dropout == 0.2


def test_transformer_init_is_flax_like():
    model = transformer.Transformer(128, 16, 2, 4).reset_parameters(
        torch.Generator().manual_seed(3))
    block = model.blocks[0]
    assert torch.equal(block.norms[0].weight, torch.ones(128))
    assert torch.equal(block.attention.q_linear.bias, torch.zeros(16))
    std = float(block.attention.q_linear.weight.detach().std())
    assert 0.07 < std < 0.1  # 1/sqrt(128)
