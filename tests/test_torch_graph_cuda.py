"""The train and eval steps as CUDA graphs, against the same steps run
eagerly, on the card.

Capture needs a card, so these tests carry the ``cuda`` marker and skip
without one.  The file imports no JAX, so it runs on a machine with the
card but without JAX:

    python -m pytest tests/test_torch_graph_cuda.py -m cuda --noconftest -q

cnn_linear/densenet18 at S = 4, batch 8, from one seeded state, TF32 off
and cuDNN's deterministic algorithms on (its default backward sums in
another order from run to run: two eager runs of 8 float32 steps then
differ by a few 1e-6 in the loss).  Graphed and eager then run the same
kernels in the same order: float32 with dropout off agrees to 1e-6 in
the losses, the params and the eval logits after 8 steps; bfloat16 with
dropout on agrees to 1e-6 in the losses, and the dropout generator ends
in the same state.
"""
import numpy as np
import pytest
import torch

from deepards_tpu_torch.data.pipeline import transform_batch
from deepards_tpu_torch.models import densenet1d, heads
from deepards_tpu_torch.train.losses import bce_with_logits
from deepards_tpu_torch.train.steps import (
    StepRunner,
    TrainState,
    make_optimizer,
    make_train_step,
)

B, S, C, L = 8, 4, 1, 224
STEPS = 8
ATOL = 1e-6


@pytest.fixture()
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (graph capture has no CPU mode)")
    flags = (torch.backends.cudnn.allow_tf32,
             torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.deterministic)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.deterministic = True
    yield torch.device("cuda")
    (torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32,
     torch.backends.cudnn.deterministic) = flags


def _batches(dev, n, seed=0):
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n):
        data = (rng.normal(size=(B, S, C, L)) * 20 + 3).astype(np.float32)
        target = np.eye(2, dtype=np.float32)[rng.integers(0, 2, size=B)]
        mask = np.ones(B, np.float32)
        mask[-2:] = 0.0
        out.append([torch.from_numpy(x).to(dev) for x in (data, target, mask)])
    return out


def _run(dev, graphed, compute_dtype=None, dropout=False, optimizer="sgd"):
    """STEPS train steps and one eval through a StepRunner: losses,
    params, final logits and the generator's state."""
    model = heads.CNNLinearNetwork(densenet1d.densenet18(), S)
    model.reset_parameters(torch.Generator().manual_seed(0))
    model.to(dev)
    state = TrainState(
        model, make_optimizer(model.parameters(), optimizer,
                              learning_rate=1e-3, weight_decay=1e-4,
                              clip_grad=True, clip_val=0.01),
        torch.Generator(device=dev).manual_seed(1))
    mu = torch.tensor([3.0], device=dev)
    std = torch.tensor([20.0], device=dev)
    train_step, eval_step = make_train_step(
        bce_with_logits, transform=lambda d: transform_batch(d, mu, std),
        compute_dtype=compute_dtype, dropout_active=dropout)
    runner = StepRunner(state, train_step, eval_step, (B, S, C, L),
                        graphed=graphed)
    losses = []
    batches = _batches(dev, STEPS + 1)
    for data, target, mask in batches[:STEPS]:
        runner.inputs["data"].copy_(data)
        runner.inputs["target"].copy_(target)
        runner.inputs["mask"].copy_(mask)
        losses.append(runner.train().clone())
    for key, value in zip(("data", "target", "mask"), batches[-1]):
        runner.inputs[key].copy_(value)
    _, out = runner.eval()
    out = out.clone()
    torch.cuda.synchronize()
    return (torch.stack(losses).cpu(),
            {k: v.detach().cpu() for k, v in model.state_dict().items()},
            out.cpu(), state.generator.get_state(), state.step)


def _max_abs(a, b):
    return max(float((a[k] - b[k]).abs().max()) for k in a)


@pytest.mark.cuda
@pytest.mark.parametrize("optimizer", ["sgd", "adam"])
def test_graphed_f32_steps_equal_eager(card, optimizer):
    dev = card
    e_loss, e_params, e_out, _, e_step = _run(dev, False, optimizer=optimizer)
    g_loss, g_params, g_out, _, g_step = _run(dev, True, optimizer=optimizer)
    assert g_step == e_step == STEPS
    assert float((g_loss - e_loss).abs().max()) <= ATOL
    assert _max_abs(g_params, e_params) <= ATOL
    assert float((g_out - e_out).abs().max()) <= ATOL
    # the steps did train: the params moved
    init = heads.CNNLinearNetwork(densenet1d.densenet18(), S)
    init.reset_parameters(torch.Generator().manual_seed(0))
    assert _max_abs(g_params, init.state_dict()) > 1e-4


@pytest.mark.cuda
def test_graphed_bf16_dropout_steps_equal_eager(card):
    dev = card
    e_loss, _, _, e_rng, _ = _run(dev, False, torch.bfloat16, dropout=True)
    g_loss, _, _, g_rng, _ = _run(dev, True, torch.bfloat16, dropout=True)
    assert float((g_loss - e_loss).abs().max()) <= ATOL
    assert torch.equal(g_rng, e_rng)
    # every replay drew new masks: the generator moved on
    fresh = torch.Generator(device=dev).manual_seed(1).get_state()
    assert not torch.equal(g_rng, fresh)


@pytest.mark.cuda
def test_capturable_adam_equals_plain_adam(card):
    """On the card the port's Adam keeps its step count there
    (``capturable``), computing the bias corrections in float32 on the
    card: 5 steps on random params and grads agree with torch's plain
    Adam to 2e-6, as the CPU test holds plain Adam to optax."""
    dev = card
    rng = np.random.default_rng(2)
    shapes = [(3, 4), (5,)]
    params = [rng.normal(size=s).astype(np.float32) for s in shapes]
    ours = [torch.nn.Parameter(torch.from_numpy(p.copy()).to(dev))
            for p in params]
    plain = [torch.nn.Parameter(torch.from_numpy(p.copy()).to(dev))
             for p in params]
    opt = make_optimizer(ours, "adam", learning_rate=0.05)
    assert opt.optimizer.param_groups[0]["capturable"]
    ref = torch.optim.Adam(plain, lr=0.05)
    for _ in range(5):
        for a, b, s in zip(ours, plain, shapes):
            g = torch.from_numpy(
                (rng.normal(size=s) * 0.5).astype(np.float32)).to(dev)
            a.grad, b.grad = g.clone(), g.clone()
        opt.step()
        ref.step()
        for a, b in zip(ours, plain):
            assert float((a - b).abs().max()) <= 2e-6


@pytest.mark.cuda
def test_capture_of_a_host_sync_raises(card):
    """A step that reads a value back to the host cannot be captured: the
    runner raises rather than fall back to eager steps."""
    dev = card
    model = heads.CNNLinearNetwork(densenet1d.densenet18(), S).to(dev)
    state = TrainState(model, make_optimizer(model.parameters()),
                       torch.Generator(device=dev))
    train_step, eval_step = make_train_step(bce_with_logits)

    def syncing_step(state, data, target, mask, meta=None):
        loss = train_step(state, data, target, mask, meta)
        float(loss)
        return loss

    with pytest.raises(RuntimeError):
        StepRunner(state, syncing_step, eval_step, (B, S, C, L),
                   graphed=True)
