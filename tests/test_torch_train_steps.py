"""The port's normalization, losses, optimizer and train step against the
JAX package, on the same seeded inputs.

Tolerances: transform_batch and the losses atol 1e-6 (one elementwise
function in another framework); the optimizer chain atol 1e-6 over five
steps (Adam 2e-6); a densenet18 cnn_linear step in float32 with dropout off, the JAX
params carried over with ``transplant``: loss and params atol 1e-5 after
each of three steps; one bfloat16 step: loss atol 2e-2 (bf16 rounds the
params and activations at 8 bits of mantissa).
"""
import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from deepards_tpu.data import pipeline as jpipeline
from deepards_tpu.models import densenet1d as jdn
from deepards_tpu.models import heads as jheads
from deepards_tpu.train import losses as jlosses
from deepards_tpu.train import steps as jsteps
from deepards_tpu_torch.data import pipeline
from deepards_tpu_torch.models import densenet1d, heads
from deepards_tpu_torch.train import losses
from deepards_tpu_torch.train.steps import (
    TrainState,
    make_optimizer,
    make_train_step,
)
from deepards_tpu_torch.transplant import load_sgd_momentum, transplant

# parallel test workers share the cores: one torch thread each
torch.set_num_threads(1)

B, S, C, L = 4, 4, 1, 224
MU, STD = np.float32([3.0]), np.float32([20.0])


def _t(x):
    return torch.from_numpy(np.asarray(x))


@pytest.mark.parametrize("is_padded", [False, True])
@pytest.mark.parametrize("zero_mu", [False, True])
def test_transform_batch_matches_jax(is_padded, zero_mu):
    rng = np.random.default_rng(0)
    data = (rng.normal(size=(3, S, 2, 16)) * 20 + 3).astype(np.float32)
    data[:, :, :, 10:] = 0.0  # padded tails
    mu = np.float32([3.0, -1.5])
    std = np.float32([20.0, 4.0])
    want = jpipeline.transform_batch(
        jnp.asarray(data), jnp.asarray(mu), jnp.asarray(std),
        jnp.zeros((1, 6), jnp.float32), is_padded=is_padded,
        zero_mu=zero_mu)
    got = pipeline.transform_batch(_t(data), _t(mu), _t(std),
                                   is_padded=is_padded, zero_mu=zero_mu)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-6,
                               rtol=0)


_LOSSES = {
    "bce": (jlosses.bce_with_logits, losses.bce_with_logits),
    "mse": (jlosses.mse, losses.mse),
    "mae": (jlosses.mae, losses.mae),
    "vacillating": (
        lambda o, t, w=None: jlosses.vacillating_loss(o, t, 0.5, w),
        lambda o, t, w=None: losses.vacillating_loss(o, t, 0.5, w)),
    "confidence": (
        lambda o, t, w=None: jlosses.confidence_penalty_loss(o, t, 0.7, w),
        lambda o, t, w=None: losses.confidence_penalty_loss(o, t, 0.7, w)),
    "focal": (lambda o, t, w=None: jlosses.focal_loss(o, t, weights=w),
              lambda o, t, w=None: losses.focal_loss(o, t, weights=w)),
}


@pytest.mark.parametrize("name", sorted(_LOSSES))
@pytest.mark.parametrize("shape", [(6, 2), (6, 5, 2)])
@pytest.mark.parametrize("masked", [False, True])
def test_losses_match_jax(name, shape, masked):
    rng = np.random.default_rng(1)
    logits = (rng.normal(size=shape) * 3).astype(np.float32)
    target = np.eye(2, dtype=np.float32)[rng.integers(0, 2, size=shape[:-1])]
    weights = np.float32([1, 1, 1, 1, 0, 0]) if masked else None
    jfn, tfn = _LOSSES[name]
    want = jfn(jnp.asarray(logits), jnp.asarray(target),
               None if weights is None else jnp.asarray(weights))
    got = tfn(_t(logits), _t(target), None if weights is None else _t(weights))
    np.testing.assert_allclose(float(got), float(want), atol=1e-6, rtol=0)


def test_classification_loss_registry():
    assert losses.get_classification_loss("bce") is losses.bce_with_logits
    with pytest.raises(ValueError):
        losses.get_classification_loss("hinge")


@pytest.mark.parametrize("clip_grad", [False, True])
@pytest.mark.parametrize("optimizer", ["sgd", "adam"])
def test_optimizer_matches_optax_chain(clip_grad, optimizer):
    """Five steps of clamp -> coupled decay -> Nesterov SGD (or Adam) on
    random params and grads; the momentum buffer after the first step is
    optax's trace started from zeros."""
    rng = np.random.default_rng(2)
    shapes = {"a": (3, 4), "b": (5,)}
    params = {k: rng.normal(size=s).astype(np.float32)
              for k, s in shapes.items()}
    kw = dict(learning_rate=0.05, weight_decay=0.01, clip_grad=clip_grad,
              clip_val=0.3)
    tx = jsteps.make_optimizer(optimizer, **kw)
    jparams = {k: jnp.asarray(v) for k, v in params.items()}
    opt_state = tx.init(jparams)
    tparams = {k: torch.nn.Parameter(_t(v.copy())) for k, v in params.items()}
    opt = make_optimizer(tparams.values(), optimizer, **kw)
    # Adam divides by sqrt(nu) + eps in another order: a few f32 roundings
    atol = 1e-6 if optimizer == "sgd" else 2e-6
    for step in range(5):
        grads = {k: (rng.normal(size=s) * 0.5).astype(np.float32)
                 for k, s in shapes.items()}
        updates, opt_state = tx.update(
            {k: jnp.asarray(v) for k, v in grads.items()}, opt_state,
            jparams)
        jparams = optax.apply_updates(jparams, updates)
        for k, p in tparams.items():
            p.grad = _t(grads[k].copy())
        opt.step()
        for k in shapes:
            np.testing.assert_allclose(tparams[k].detach().numpy(),
                                       np.asarray(jparams[k]), atol=atol,
                                       rtol=0)
        if optimizer == "sgd" and step == 0:
            trace = opt_state[-1][0].trace
            for k, p in tparams.items():
                np.testing.assert_allclose(
                    opt.optimizer.state[p]["momentum_buffer"].numpy(),
                    np.asarray(trace[k]), atol=1e-6, rtol=0)


def _batches(n, seed=3):
    """``n`` raw batches; the last row of each is a pad row (mask 0)."""
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n):
        data = (rng.normal(size=(B, S, C, L)) * 20 + 3).astype(np.float32)
        target = np.eye(2, dtype=np.float32)[rng.integers(0, 2, size=B)]
        mask = np.float32([1, 1, 1, 0])
        out.append((data, target, mask))
    return out


class _Pair:
    """The same cnn_linear/densenet18 and optimizer in both packages."""

    def __init__(self, compute_dtype=None, seed=0, **opt):
        self.jmodel = jheads.CNNLinearNetwork(breath_block=jdn.densenet18())
        self.tx = jsteps.make_optimizer("sgd", **opt)
        sample = {"data": np.zeros((B, S, C, L), np.float32)}
        self.jstate = jsteps.create_train_state(
            self.jmodel, self.tx, sample, jax.random.PRNGKey(seed))
        mu, std = jnp.asarray(MU), jnp.asarray(STD)
        jdtype = {None: None, torch.bfloat16: jnp.bfloat16}[compute_dtype]
        self.jtrain, self.jeval, _, _ = jsteps.make_train_step(
            self.jmodel, self.tx, jlosses.bce_with_logits,
            transform=lambda d: jpipeline.transform_batch(
                d, mu, std, jnp.zeros((1, 6), jnp.float32)),
            compute_dtype=jdtype, dropout_active=False)
        model = heads.CNNLinearNetwork(densenet1d.densenet18(), S)
        model.load_state_dict(transplant(self.jparams()))
        self.state = TrainState(
            model, make_optimizer(model.parameters(), "sgd", **opt),
            torch.Generator())
        self.ttrain, self.teval = make_train_step(
            losses.bce_with_logits,
            transform=lambda d: pipeline.transform_batch(d, _t(MU), _t(STD)),
            compute_dtype=compute_dtype, dropout_active=False)

    def jparams(self):
        return jax.tree_util.tree_map(np.asarray, self.jstate.params)

    def step(self, data, target, mask):
        self.jstate, jloss = self.jtrain(
            self.jstate, {"data": jnp.asarray(data),
                          "target": jnp.asarray(target)}, jnp.asarray(mask))
        tloss = self.ttrain(self.state, _t(data), _t(target), _t(mask))
        return float(tloss), float(jloss)

    def assert_params_close(self, atol):
        want = transplant(self.jparams())
        got = self.state.model.state_dict()
        for k in want:
            np.testing.assert_allclose(got[k].numpy(), want[k].numpy(),
                                       atol=atol, rtol=0, err_msg=k)


@pytest.mark.parametrize("opt,params_steps", [
    (dict(learning_rate=0.001, weight_decay=0.0001, clip_grad=True,
          clip_val=0.01), 3),
    # without the clip at lr 0.05 the run is chaotic: conv0's gradient
    # outweighs its kernel, so the port's own params, changed by 1e-7
    # (relative), drift past 1e-5 by the third step (checked below).  The
    # third step's params cannot be compared at 1e-5; its loss still is.
    (dict(learning_rate=0.05, weight_decay=0.0001, clip_grad=False), 2),
    # without the clip at lr 0.01 the nudge stays under 1e-5 for all three
    # steps (checked below): params and eval compared in full
    (dict(learning_rate=0.01, weight_decay=0.0001, clip_grad=False), 3),
], ids=["clip0.01", "noclip-lr0.05", "noclip-lr0.01"])
def test_f32_train_steps_match_jax(opt, params_steps):
    pair = _Pair(**opt)
    nudged = _nudged_copy(pair, opt)
    for step, (data, target, mask) in enumerate(_batches(3)):
        tloss, jloss = pair.step(data, target, mask)
        assert abs(tloss - jloss) <= 1e-5, (step, tloss, jloss)
        if step < params_steps:
            pair.assert_params_close(1e-5)
        pair.ttrain(nudged, _t(data), _t(target), _t(mask))
    mine, theirs = pair.state.model.state_dict(), nudged.model.state_dict()
    drift = max(float((mine[k] - theirs[k]).abs().max()) for k in mine)
    # the params compared are those a 1e-7 nudge moves by less than 1e-5
    assert (drift < 1e-5) == (params_steps == 3), drift
    if params_steps < 3:
        return
    # eval: same logits and loss, no update
    data, target, mask = _batches(1, seed=4)[0]
    jstate, jloss, jout = pair.jeval(
        pair.jstate, {"data": jnp.asarray(data),
                      "target": jnp.asarray(target)}, jnp.asarray(mask))
    tloss, tout = pair.teval(pair.state, _t(data), _t(target), _t(mask))
    np.testing.assert_allclose(tout.numpy(), np.asarray(jout), atol=1e-5,
                               rtol=0)
    assert abs(float(tloss) - float(jloss)) <= 1e-5


def _nudged_copy(pair, opt):
    """The port's model and optimizer of ``pair`` with every param scaled
    by 1 + 1e-7 * N(0, 1)."""
    model = heads.CNNLinearNetwork(densenet1d.densenet18(), S)
    model.load_state_dict(pair.state.model.state_dict())
    gen = torch.Generator().manual_seed(0)
    with torch.no_grad():
        for p in model.parameters():
            p.mul_(1 + 1e-7 * torch.randn(p.shape, generator=gen))
    return TrainState(model, make_optimizer(model.parameters(), "sgd", **opt),
                      torch.Generator())


def test_step_from_a_mid_run_state_matches_jax():
    """The JAX run's params and optax momentum trace carried into a fresh
    port model and torch SGD: the next step agrees."""
    opt = dict(learning_rate=0.001, weight_decay=0.0001, clip_grad=True,
               clip_val=0.01)
    pair = _Pair(**opt)
    batches = _batches(3)
    for data, target, mask in batches[:2]:
        pair.step(data, target, mask)
    model = heads.CNNLinearNetwork(densenet1d.densenet18(), S)
    model.load_state_dict(transplant(pair.jparams()))
    optimizer = make_optimizer(model.parameters(), "sgd", **opt)
    load_sgd_momentum(optimizer.optimizer, model, pair.jstate.opt_state)
    pair.state = TrainState(model, optimizer, torch.Generator())
    tloss, jloss = pair.step(*batches[2])
    assert abs(tloss - jloss) <= 1e-5
    pair.assert_params_close(1e-5)


def test_bf16_train_step_close_to_jax():
    pair = _Pair(compute_dtype=torch.bfloat16, learning_rate=0.001,
                 weight_decay=0.0001, clip_grad=True, clip_val=0.01)
    tloss, jloss = pair.step(*_batches(1)[0])
    assert abs(tloss - jloss) <= 2e-2, (tloss, jloss)
    # master params and grads stay float32
    for p in pair.state.model.parameters():
        assert p.dtype == torch.float32 and p.grad.dtype == torch.float32


def test_eval_dropout_advances_the_generator():
    """cnn_linear keeps dropout at eval; each eval draws fresh masks."""
    model = heads.CNNLinearNetwork(densenet1d.densenet18(), S)
    model.reset_parameters(torch.Generator().manual_seed(0))
    state = TrainState(model, make_optimizer(model.parameters()),
                       torch.Generator().manual_seed(1))
    _, teval = make_train_step(losses.bce_with_logits)
    data, target, mask = (_t(x) for x in _batches(1)[0])
    _, first = teval(state, data, target, mask)
    _, second = teval(state, data, target, mask)
    assert not torch.equal(first, second)
    state.generator.manual_seed(1)
    _, again = teval(state, data, target, mask)
    assert torch.equal(first, again)
