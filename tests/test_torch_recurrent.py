"""The LSTM and the CNN + LSTM networks (benchmark config 4's cnn_lstm)
against the JAX package's flax ``OptimizedLSTMCell`` under ``nn.RNN``.

Parameters are numpy draws in the flax tree's shapes, carried over with
``transplant`` (``test_torch_configs_2_3_4.random_params``); the backbone
is a narrow resnet18 (``initial_planes`` 8), dropout off.  Tolerances:
the LSTM alone 1e-5, the networks' logits and carries 1e-4 in float32; a
bfloat16 forward 2e-2, the bf16 tolerance of
``test_torch_train_steps.py`` (bf16 rounds params and activations at 8
bits of mantissa; flax keeps the carry and the gates in float32, as the
port does).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import linen as flax_nn
from test_torch_configs_2_3_4 import (
    assert_round_trip,
    assert_three_train_steps_match_jax,
    jit_apply,
    random_params,
    windows,
)

from deepards_tpu.models import heads as jheads
from deepards_tpu.models import recurrent as jrecurrent
from deepards_tpu.models import resnet1d as jresnet
from deepards_tpu_torch.cli.serve import InferenceEngine
from deepards_tpu_torch.models import densenet1d, heads, recurrent, resnet1d
from deepards_tpu_torch.ops import lstm as lstm_ops
from deepards_tpu_torch.train import checkpoint
from deepards_tpu_torch.transplant import transplant
from deepards_tpu_torch.utils import profiling

# parallel test workers share the cores: one torch thread each
torch.set_num_threads(1)

B, S, L, F, H = 2, 3, 224, 24, 16
PLANES = 8
BF16_ATOL = 2e-2


class JaxLSTM(flax_nn.Module):
    """flax's cell under ``nn.RNN``, as ``CNNLSTMNetwork`` holds it."""

    hidden: int = H

    @flax_nn.compact
    def __call__(self, x, carry=None):
        rnn = flax_nn.RNN(flax_nn.OptimizedLSTMCell(features=self.hidden),
                          return_carry=True)
        if carry is None:
            return rnn(x)
        return rnn(x, initial_carry=carry)


def _port_lstm(params):
    model = torch.nn.ModuleDict({"lstm": recurrent.LSTM(F, H)})
    model.load_state_dict(transplant(params))
    return model["lstm"]


def _bf16(tree):
    return jax.tree_util.tree_map(lambda a: jnp.asarray(a, jnp.bfloat16),
                                  tree)


@pytest.mark.parametrize("with_carry", [False, True])
def test_lstm_matches_flax_rnn(with_carry):
    x = windows(0, (B, S, F))
    carry = None
    if with_carry:
        carry = (windows(1, (B, H)), windows(2, (B, H)))
    jlstm = JaxLSTM()
    params = random_params(jlstm, 3, jnp.asarray(x))
    jcarry = None if carry is None else tuple(map(jnp.asarray, carry))
    (wc, wh), wout = jax.jit(lambda p, v, c: jlstm.apply(
        {"params": p}, v, c))(params, jnp.asarray(x), jcarry)
    lstm = _port_lstm(params)
    tcarry = None if carry is None else tuple(map(torch.from_numpy, carry))
    with torch.no_grad():
        (c, h), out = lstm(torch.from_numpy(x), tcarry)
    for got, want in ((out, wout), (c, wc), (h, wh)):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5,
                                   rtol=0)
    np.testing.assert_array_equal(out[:, -1].numpy(), h.numpy())


def test_lstm_bf16_keeps_the_carry_float32_as_flax():
    """bf16 params and inputs: the input projection in bf16, the carry,
    gates and outputs in float32 on both sides."""
    x = windows(4, (B, S, F))
    jlstm = JaxLSTM()
    params = random_params(jlstm, 5, jnp.asarray(x))
    (_, wh), wout = jlstm.apply({"params": _bf16(params)},
                                jnp.asarray(x, jnp.bfloat16))
    lstm = _port_lstm(params)
    cast = {k: v.to(torch.bfloat16) for k, v in lstm.named_parameters()}
    with torch.no_grad():
        (_, h), out = torch.func.functional_call(
            lstm, cast, (torch.from_numpy(x).to(torch.bfloat16),))
    assert wout.dtype == jnp.float32 and out.dtype == torch.float32
    assert h.dtype == torch.float32
    np.testing.assert_allclose(out.numpy(), np.asarray(wout),
                               atol=BF16_ATOL, rtol=0)


def test_lstm_init_is_flax_like():
    """Seeded: input kernels at lecun-normal scale, each gate's recurrent
    kernel orthogonal, biases zero."""
    a, b = (recurrent.LSTM(128, H).reset_parameters(
        torch.Generator().manual_seed(2)) for _ in range(2))
    for (k, v), w in zip(a.state_dict().items(), b.state_dict().values()):
        assert torch.equal(v, w), k
    for g in recurrent.GATES:
        w = a.hidden[g].weight.detach()
        torch.testing.assert_close(w @ w.T, torch.eye(H), atol=1e-5, rtol=0)
        assert torch.equal(a.hidden[g].bias, torch.zeros(H))
        assert 0.06 < float(a.input[g].weight.detach().std()) < 0.11
    (c, h), _ = a(torch.zeros(2, 4, 128))
    assert c.dtype == h.dtype == torch.float32
    # a float64 model (a reference) promotes the float32 zero carry
    (c, h), out = a.double()(torch.zeros(2, 4, 128, dtype=torch.float64))
    assert c.dtype == h.dtype == out.dtype == torch.float64


def _jax_cnn_lstm(metadata_features, bm_to_linear, bn_scope="batch"):
    return jrecurrent.CNNLSTMNetwork(
        breath_block=jresnet.resnet18(initial_planes=PLANES),
        lstm_hidden_units=H, metadata_features=metadata_features,
        bm_to_linear=bm_to_linear, bn_scope=bn_scope)


def _port_cnn_lstm(params, metadata_features, bm_to_linear,
                   bn_scope="batch"):
    model = recurrent.CNNLSTMNetwork(
        resnet1d.resnet18(initial_planes=PLANES), H, metadata_features,
        bm_to_linear, bn_scope)
    model.load_state_dict(transplant(params))
    return model


VARIANTS = [(0, False, "batch"), (9, False, "batch"), (9, True, "batch"),
            (0, False, "sequence")]


@pytest.mark.parametrize("m,bm_to_linear,bn_scope", VARIANTS)
def test_cnn_lstm_matches_flax(m, bm_to_linear, bn_scope):
    """Per-window logits (B, S, 2) and the final carry, started from a
    carry passed in, with and without the metadata input."""
    x = windows(6, (B, S, 1, L))
    meta = windows(7, (B, S, 9)) if m else None
    hidden = H + (0 if bm_to_linear else m)
    carry = (windows(8, (B, hidden)), windows(9, (B, hidden)))
    jmodel = _jax_cnn_lstm(m, bm_to_linear, bn_scope)
    jmeta = None if meta is None else jnp.asarray(meta)
    params = random_params(jmodel, 10, jnp.asarray(x), jmeta, True)
    apply = jax.jit(lambda p, v, md, c: jmodel.apply(
        {"params": p}, v, md, True, c))
    wlogits, (wc, wh) = apply(params, jnp.asarray(x), jmeta,
                              tuple(map(jnp.asarray, carry)))
    model = _port_cnn_lstm(params, m, bm_to_linear, bn_scope)
    with torch.no_grad():
        logits, (c, h) = model(
            torch.from_numpy(x), True, None,
            None if meta is None else torch.from_numpy(meta),
            tuple(map(torch.from_numpy, carry)))
    assert logits.shape == (B, S, 2)
    for got, want in ((logits, wlogits), (c, wc), (h, wh)):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-4,
                                   rtol=0)


def test_cnn_lstm_bf16_forward_close_to_flax():
    x = windows(11, (B, S, 1, L))
    meta = windows(12, (B, S, 9))
    jmodel = _jax_cnn_lstm(9, False)
    params = random_params(jmodel, 13, jnp.asarray(x), jnp.asarray(meta),
                           True)
    want, _ = jit_apply(jmodel, True)(
        _bf16(params), jnp.asarray(x, jnp.bfloat16), None, jnp.asarray(meta))
    model = _port_cnn_lstm(params, 9, False)
    cast = {k: v.to(torch.bfloat16) for k, v in model.named_parameters()}
    with torch.no_grad():
        got, _ = torch.func.functional_call(
            model, cast, (torch.from_numpy(x).to(torch.bfloat16), True, None,
                          torch.from_numpy(meta)))
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(want, np.float32),
                               atol=BF16_ATOL, rtol=0)


@pytest.mark.parametrize("bm_to_linear", [False, True])
def test_cnn_lstm_double_linear_matches_flax(bm_to_linear):
    x = windows(14, (B, S, 1, L))
    meta = windows(15, (B, S, 9))
    jmodel = jrecurrent.CNNLSTMDoubleLinearNetwork(
        breath_block=jresnet.resnet18(initial_planes=PLANES),
        lstm_hidden_units=H, metadata_features=9, bm_to_linear=bm_to_linear)
    params = random_params(jmodel, 16, jnp.asarray(x), jnp.asarray(meta),
                           True)
    want = jit_apply(jmodel, True)(params, jnp.asarray(x), None,
                                   jnp.asarray(meta))
    model = recurrent.CNNLSTMDoubleLinearNetwork(
        resnet1d.resnet18(initial_planes=PLANES), S, H, 9, bm_to_linear)
    model.load_state_dict(transplant(params))
    with torch.no_grad():
        got = model(torch.from_numpy(x), True, None, torch.from_numpy(meta))
    assert got.shape == (B, 2)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-4,
                               rtol=0)


def test_transplant_round_trips_lstm_trees():
    """cnn_lstm (an LSTM cell at the top level), cnn_lstm_double_linear
    (a chain of two Dense layers) and metadata_only (a chain of three, no
    backbone)."""
    x = jnp.zeros((B, S, 1, L), jnp.float32)
    meta = jnp.zeros((B, S, 9), jnp.float32)
    lstm = assert_round_trip(
        random_params(_jax_cnn_lstm(9, False), 17, x, meta, True),
        recurrent.CNNLSTMNetwork(resnet1d.resnet18(initial_planes=PLANES),
                                 H, 9))
    assert tuple(lstm["lstm.input.f.weight"].shape) == (H + 9, 64 + 9)
    assert tuple(lstm["lstm.hidden.o.bias"].shape) == (H + 9,)
    assert tuple(lstm["head.weight"].shape) == (2, H + 9)
    double = assert_round_trip(
        random_params(jrecurrent.CNNLSTMDoubleLinearNetwork(
            breath_block=jresnet.resnet18(initial_planes=PLANES),
            lstm_hidden_units=H), 18, x, None, True),
        recurrent.CNNLSTMDoubleLinearNetwork(
            resnet1d.resnet18(initial_planes=PLANES), S, H))
    assert tuple(double["layers.0.weight"].shape) == (H, S * H)
    meta_only = assert_round_trip(
        random_params(jheads.MetadataOnlyNetwork(), 19, x, meta, True),
        heads.MetadataOnlyNetwork())
    assert sorted(meta_only) == ["layers.{}.{}".format(i, leaf)
                                 for i in range(3)
                                 for leaf in ("bias", "weight")]


def test_config4_train_steps_match_jax():
    """cnn_lstm over densenet18: the per-breath target repeated over the
    windows in the loss, three steps as in the JAX package."""
    assert_three_train_steps_match_jax("config4")


def test_cnn_lstm_served_as_its_trainer_evaluates(tmp_path):
    """A cnn_lstm checkpoint is served with dropout off (its trainer's
    eval) and a window's probabilities are the mean of its windows'
    softmaxes; a regressor is refused."""
    model = recurrent.CNNLSTMNetwork(densenet1d.densenet18(), 16,
                                     bn_scope="sequence").reset_parameters(
        torch.Generator().manual_seed(0))
    path = checkpoint.save(str(tmp_path / "lstm.pt"), model.state_dict())
    engine = InferenceEngine(path, network="cnn_lstm", n_sub_batches=S,
                             batch_size=4, device="cpu")
    x = windows(20, (B, S, 1, L))
    with torch.no_grad():
        logits, _ = model(torch.from_numpy(x), True)
    want = torch.softmax(logits, -1).mean(dim=1).numpy()
    np.testing.assert_allclose(engine.predict(x), want, atol=1e-6, rtol=0)
    np.testing.assert_array_equal(engine.predict(x), engine.predict(x))
    with pytest.raises(ValueError, match="regressor"):
        InferenceEngine(path, network="cnn_regressor", device="cpu")


def test_lstm_takes_the_loop_on_the_cpu_and_under_vmap():
    """On the CPU, and under ``torch.func.vmap`` (which a hand kernel has
    no rule for), the forward runs the loop and counts its steps there."""
    lstm = recurrent.LSTM(F, H).reset_parameters(
        torch.Generator().manual_seed(6))
    x = torch.from_numpy(windows(6, (B, S, F)))
    profiling.reset_totals()
    (_, h), out = lstm(x)
    counters = profiling.totals()["counters"]
    assert counters == {"lstm.loop_steps": S}
    assert lstm_ops.kernel_plan(x, torch.zeros(4 * H, H)) is None
    seen = []

    def one(v):
        seen.append(lstm_ops.transform_active())
        return lstm(v[None])[1][0]

    stacked = torch.func.vmap(one)(x)
    assert seen == [True] and not lstm_ops.transform_active()
    assert profiling.totals()["counters"] == {"lstm.loop_steps": 2 * S}
    torch.testing.assert_close(stacked, out, atol=1e-6, rtol=0)
    assert torch.equal(out[:, -1], h)


# (batch, hidden, carry type) of each LSTM user -> (cluster, parts, k,
# rows, threads, blocks) on an H100's 132 SMs
PLANS = {
    "nested": ((1, 128, torch.float32), (4, 4, 32, 1, 512, 4)),
    "cnn_lstm": ((16, 16, torch.float32), (1, 1, 16, 1, 64, 16)),
    "cnn_lstm_metadata": ((16, 25, torch.float32), (1, 2, 16, 1, 224, 16)),
    "lstm_only": ((320, 16, torch.float32), (1, 1, 16, 3, 192, 107)),
    "float64": ((2, 128, torch.float64), (8, 8, 16, 1, 512, 16)),
}


@pytest.mark.parametrize("user", sorted(PLANS))
def test_lstm_plan_at_each_users_shape(user):
    (batch, hidden, dtype), want = PLANS[user]
    plan = lstm_ops.lstm_plan(batch, hidden, dtype)
    assert (plan.cluster, plan.parts, plan.k, plan.rows, plan.threads,
            plan.blocks) == want


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_lstm_plan_keeps_the_kernels_limits(dtype):
    """Every plan fits the kernels: a block's weights within 64 KB and K
    a thread, its batch rows within 512 threads and 48 KB of shared
    memory, every batch row in some cluster; a W_h too large for 8
    blocks, or another carry type, gets no plan."""
    elem = torch.finfo(dtype).bits // 8
    for hidden in (1, 3, 16, 25, 64, 100, 128, 181):
        for batch in (1, 2, 16, 133, 320, 5000):
            plan = lstm_ops.lstm_plan(batch, hidden, dtype)
            if plan is None:  # no cluster of 8 takes it
                units = -(-hidden // 8)
                assert 4 * hidden * units * elem > 64 * 1024 or all(
                    4 * units * p > 512
                    or -(-hidden // p) > max(lstm_ops.KS[dtype])
                    for p in lstm_ops.PARTS)
                continue
            units = -(-hidden // plan.cluster)
            assert units == plan.units
            assert 4 * units * hidden * elem <= lstm_ops.WEIGHT_BYTES
            assert plan.k in lstm_ops.KS[dtype]
            assert plan.k * plan.parts >= hidden
            assert plan.rows * 4 * units * plan.parts <= plan.threads <= 512
            assert plan.threads % 32 == 0
            # the backward's two buffers of 4 K P gate gradients a row
            assert 8 * plan.rows * plan.k * plan.parts * elem <= 48 * 1024
            assert plan.blocks // plan.cluster * plan.rows >= batch
            smaller = [c for c in lstm_ops.CLUSTERS if c < plan.cluster]
            assert all(4 * -(-hidden // c) * hidden * elem
                       > lstm_ops.WEIGHT_BYTES for c in smaller)
    assert lstm_ops.lstm_plan(16, 16, torch.bfloat16) is None
    assert lstm_ops.lstm_plan(1, 200, torch.float32) is None
