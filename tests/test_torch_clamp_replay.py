"""``chip_smoke.clamp_mode`` and ``flipped`` on the CPU: the float64
run's clamp decisions recorded, replayed into a float32 run, and one
decision flipped; outside the mode the optimizer's clamp is its own."""
import contextlib

import numpy as np
import torch

import chip_smoke
from deepards_tpu_torch.train.steps import make_optimizer

CLIP = 0.01


def _run(dtype, records=None, replay=None, mode=True):
    """Three clipped SGD steps of a seeded linear layer whose gradients
    are mostly beyond the clip: (params after each step, the model)."""
    torch.manual_seed(0)
    model = torch.nn.Linear(6, 4).to(dtype)
    rng = np.random.default_rng(1)
    xs = torch.as_tensor(rng.normal(size=(3, 8, 6)), dtype=dtype)
    ys = torch.as_tensor(rng.normal(size=(3, 8, 4)), dtype=dtype)
    opt = make_optimizer(model.parameters(), clip_grad=True, clip_val=CLIP,
                         learning_rate=0.1)
    out = []
    with chip_smoke.clamp_mode(model, records, replay) if mode else \
            contextlib.nullcontext():
        for x, y in zip(xs, ys):
            opt.zero_grad()
            (10 * (model(x) - y) ** 2).mean().backward()
            opt.step()
            out.append({n: p.detach().double().clone()
                        for n, p in model.named_parameters()})
    return out, model


def test_records_each_clamp_call_by_parameter():
    records = []
    _run(torch.float64, records=records)
    # a step: the clamp to -clip, then to +clip
    assert len(records) == 6
    assert all(set(r) == {"weight", "bias"} for r in records)
    assert sum(int(m.sum()) for r in records for m in r.values()) > 0


def test_recording_leaves_the_clamp_as_it_is():
    with_mode, _ = _run(torch.float64, records=[])
    without, _ = _run(torch.float64, mode=False)
    for a, b in zip(with_mode, without):
        for n in a:
            assert torch.equal(a[n], b[n])


def test_replay_of_a_runs_own_decisions_changes_nothing():
    records = []
    own, _ = _run(torch.float32, records=records)
    replayed, _ = _run(torch.float32, replay=records)
    for a, b in zip(own, replayed):
        for n in a:
            assert torch.equal(a[n], b[n])


def test_a_flipped_decision_moves_its_element():
    records = []
    exact, _ = _run(torch.float64, records=records)
    flip = chip_smoke.flipped(records, ["weight", "bias"])
    assert flip is not None
    flipped_records, tensor, step = flip
    got, _ = _run(torch.float64, replay=flipped_records)
    # at the flip's step one element moves, its gradient from one bound
    # to the other (2 x clip) through Nesterov's lr x (1 + momentum)
    diffs = {n: (got[step - 1][n] - exact[step - 1][n]).abs()
             for n in exact[0]}
    assert sum(int((d > 0).sum()) for d in diffs.values()) == 1
    assert float(diffs[tensor].max()) > 0.1 * 2 * CLIP
    # the records themselves are left as they were
    assert chip_smoke.flipped(records, ["weight", "bias"])[1:] == (tensor,
                                                                  step)


def test_own_clamps_networks_take_no_replay():
    assert chip_smoke.OWN_CLAMPS == ("cnn_linear_se_resnext50_32x4d",)
    assert not set(chip_smoke.OWN_CLAMPS) & set(
        chip_smoke.FLOAT32_PARAM_STEPS)
