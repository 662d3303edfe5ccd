"""The LSTM recurrence kernels on the card, against the plain loop.

The kernels have no CPU mode, so these tests carry the ``cuda`` marker
and skip without a card.  The file imports no JAX, so it runs on a
machine with the card but without JAX:

    python -m pytest tests/test_torch_lstm_cuda.py -m cuda --noconftest -q

Each network's ``LSTM`` runs twice on the card from the same parameters
and inputs: through the kernels (``ops/lstm.py`` ``recurrence``) and
through ``lstm_reference`` (the loop, taken by a ``kernel_plan`` that
gives no plan), forward and backward.  Tolerances, because both sides
compute the same values in the carry type with sums in another order
(the kernel's dots against cuBLAS's, the weight gradient as one product
over all B * S rows against S products added up), not at a lower
precision:

- float32 carry: outputs and carry within 2e-5 (|h| <= 1, a few rounding
  steps of 6e-8 that the recurrence carries over S steps); every
  gradient within 2e-4 of its largest element.
- bf16 compute: every gradient passes a bfloat16 cast (x's through dxi,
  each parameter's through the cast of the parameters), so each is held
  within 1/64 of its largest element: two of bf16's rounding steps
  (2^-7 of a value) where the two sides' float32 values round to
  neighbouring bf16 values.  The float32 cases hold the same kernels'
  gradients at the float32 tolerance, the nested shape among them.
- float64 carry: 1e-10 in every case.
"""
import numpy as np
import pytest
import torch

from deepards_tpu_torch.models import recurrent
from deepards_tpu_torch.ops import lstm as lstm_ops
from deepards_tpu_torch.utils import profiling

F32_OUT, F32_GRAD, BF16_GRAD, F64 = 2e-5, 2e-4, 1 / 64, 1e-10


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _case(seed, batch, steps, features, hidden, dtype, dev, carry):
    """A seeded LSTM on the card, its inputs, an optional carry and the
    random weights of a loss over every output."""
    lstm = recurrent.LSTM(features, hidden).reset_parameters(
        torch.Generator().manual_seed(seed))
    lstm = lstm.to(dev, torch.float64 if dtype == torch.float64
                   else torch.float32)
    rng = np.random.default_rng(seed)
    x = torch.from_numpy(rng.normal(size=(batch, steps, features)))
    x = x.to(dev, dtype).requires_grad_()
    cdtype = torch.float64 if dtype == torch.float64 else torch.float32
    start = None
    if carry:
        start = tuple(torch.from_numpy(0.5 * rng.normal(size=(
            batch, hidden))).to(dev, cdtype).requires_grad_()
            for _ in range(2))
    weights = [torch.from_numpy(rng.normal(size=s)).to(dev, cdtype)
               for s in ((batch, steps, hidden), (batch, hidden),
                         (batch, hidden))]
    return lstm, x, start, weights


def _run(lstm, x, start, weights, dtype):
    """Outputs, carry and every gradient of one forward and backward."""
    params = dict(lstm.named_parameters())
    if dtype == torch.bfloat16:  # bf16 compute: cast params, as the steps
        cast = {k: v.to(torch.bfloat16) for k, v in params.items()}
        (c, h), out = torch.func.functional_call(lstm, cast, (x, start))
    else:
        (c, h), out = lstm(x, start)
    loss = sum((t * w).sum() for t, w in zip((out, c, h), weights))
    leaves = [x, *params.values(), *(start or ())]
    grads = torch.autograd.grad(loss, leaves)
    names = ["x", *params, *(["c0", "h0"] if start else [])]
    got = {"out": out, "c": c, "h": h}
    got.update({"d" + n: g for n, g in zip(names, grads)})
    return {k: v.detach() for k, v in got.items()}


def _loop_plan(monkeypatch):
    monkeypatch.setattr(lstm_ops, "kernel_plan", lambda xi, w_h: None)


def _compare(got, want, dtype):
    for name, w in want.items():
        g = got[name]
        assert g.dtype == w.dtype and g.shape == w.shape, name
        assert torch.isfinite(g).all(), name
        err = float((g.double() - w.double()).abs().max())
        scale = float(w.double().abs().max())
        if dtype == torch.float64:
            limit = F64
        elif name in ("out", "c", "h"):
            limit = F32_OUT
        elif dtype == torch.bfloat16:
            limit = BF16_GRAD * scale
        else:
            limit = F32_GRAD * scale
        assert err <= limit, (name, err, limit, scale)


# (batch, steps, features, hidden, input dtype, carry): each user's shape
SHAPES = {
    "nested": (1, 2048, 128, 128, torch.bfloat16, False),
    "nested_float32": (1, 2048, 128, 128, torch.float32, False),
    "cnn_lstm": (16, 20, 128, 16, torch.bfloat16, False),
    "cnn_lstm_carry": (16, 20, 128, 16, torch.float32, True),
    "lstm_only": (320, 224, 1, 16, torch.float32, False),
    "double_lstm_second": (16, 20, 3584, 16, torch.bfloat16, False),
    "float64": (2, 64, 8, 128, torch.float64, True),
}


@pytest.mark.cuda
@pytest.mark.parametrize("name", sorted(SHAPES))
def test_lstm_kernel_matches_the_loop_on_card(name, monkeypatch):
    dev = _card()
    batch, steps, features, hidden, dtype, carry = SHAPES[name]
    case = _case(len(name), batch, steps, features, hidden, dtype, dev,
                 carry)
    profiling.reset_totals()
    before = lstm_ops.launches
    got = _run(*case, dtype)
    torch.cuda.synchronize()
    assert lstm_ops.launches == before + 2  # one forward, one backward
    assert profiling.totals()["counters"]["lstm.kernel_steps"] == steps
    _loop_plan(monkeypatch)
    want = _run(*case, dtype)
    assert lstm_ops.launches == before + 2
    _compare(got, want, dtype)


@pytest.mark.cuda
def test_lstm_kernel_no_grad_forward_on_card(monkeypatch):
    """Under no_grad one launch, nothing saved, the same outputs."""
    dev = _card()
    lstm, x, start, _ = _case(3, 16, 20, 128, 16, torch.float32, dev, True)
    before = lstm_ops.launches
    with torch.no_grad():
        (c, h), out = lstm(x, start)
        assert lstm_ops.launches == before + 1
        (c2, h2), out2 = lstm(x, start)
    assert torch.equal(out, out2) and torch.equal(c, c2)  # repeatable
    _loop_plan(monkeypatch)
    with torch.no_grad():
        (wc, wh), wout = lstm(x, start)
    for got, want in ((out, wout), (c, wc), (h, wh)):
        assert float((got - want).abs().max()) <= F32_OUT


@pytest.mark.cuda
def test_lstm_kernel_replays_in_a_cuda_graph_on_card():
    """A captured forward and backward at the nested shape, replayed
    twice, equals the eager call bit for bit (the kernels use no atomics:
    the same inputs give the same sums)."""
    dev = _card()
    lstm, x, _, weights = _case(7, 1, 2048, 128, 128, torch.float32, dev,
                                False)
    params = list(lstm.parameters())

    def step():
        (c, h), out = lstm(x)
        loss = sum((t * w).sum() for t, w in zip((out, c, h), weights))
        return [out.detach(), *torch.autograd.grad(loss, [x, *params])]

    eager = step()
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        step()  # warm-up on the capture's stream
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    before = lstm_ops.launches
    with torch.cuda.graph(graph):
        static = step()
    assert lstm_ops.launches == before + 2
    for _ in range(2):
        for t in static:
            t.fill_(float("nan"))
        graph.replay()
        torch.cuda.synchronize()
        for got, want in zip(static, eager):
            assert torch.equal(got, want)


@pytest.mark.cuda
def test_lstm_kernel_refuses_what_it_does_not_take_on_card():
    dev = _card()
    xi = torch.zeros(2, 3, 64, device=dev)
    w_h = torch.zeros(64, 16, device=dev)
    b_h = torch.zeros(64, device=dev)
    c = h = torch.zeros(2, 16, device=dev)
    plan = lstm_ops.lstm_plan(2, 16, torch.float32)
    with pytest.raises(TypeError):
        lstm_ops.lstm_cuda(xi, w_h, b_h.double(), c, h, plan)
    with pytest.raises(ValueError):
        lstm_ops.lstm_cuda(xi[:, :, :60], w_h, b_h, c, h, plan)
    with pytest.raises(RuntimeError, match="invalid argument"):
        lstm_ops.lstm_cuda(xi, w_h, b_h, c, h, plan._replace(parts=3))
