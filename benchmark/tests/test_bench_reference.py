"""The plain reference equals the port at a small size on the CPU, given
the same weights, inputs and dropout masks (float32, the port's own
modules and steps)."""
import numpy as np
import pytest
import torch

import bench_tiny  # noqa: F401  (puts the repository on the path)
from benchmark import weights as weights_lib
from benchmark.reference import flops, folds, model, networks, runs

from deepards_tpu_torch.config.config import Configuration
from deepards_tpu_torch.models.layers import bn_row_mask
from deepards_tpu_torch.models.registry import (
    get_base_network,
    get_network_spec,
)
from deepards_tpu_torch.train import losses
from deepards_tpu_torch.train.nested_trainer import make_nested_steps
from deepards_tpu_torch.train.steps import (
    TrainState,
    make_optimizer,
    make_train_step,
)

S = 3


def port_model(network, weights):
    conf = Configuration(overrides={"network": network,
                                    "base_network": "densenet18"}).conf
    spec = get_network_spec(network)
    net = spec.build(conf, get_base_network(conf, 1), S, 0)
    params = dict(net.named_parameters())
    assert set(params) == set(weights)
    with torch.no_grad():
        for k, p in params.items():
            p.copy_(weights[k])
    return net


def assert_changes(net, w, want):
    """Each leaf's change within 1e-3 of its own or the median leaf's,
    whichever is larger: float32 round-off where a leaf's gradient
    cancels."""
    median = float(np.median(list(want.values())))
    for name, p in net.named_parameters():
        change = float((p.detach() - w[name]).norm())
        assert abs(change - want[name]) <= 1e-3 * max(want[name], median), \
            name


@pytest.mark.parametrize("network", ["cnn_linear", "cnn_to_nested_lstm"])
def test_param_spec_names_the_port_leaves(network):
    w = weights_lib.make_weights(network, S, 3, "cpu")
    net = port_model(network, w)
    for name, p in net.named_parameters():
        assert tuple(p.shape) == tuple(w[name].shape)


def test_cnn_linear_logits_and_gradients_equal_the_port():
    w = weights_lib.make_weights("cnn_linear", S, 5, "cpu")
    net = port_model("cnn_linear", w)
    x = torch.randn(4, S, 1, 224, generator=torch.Generator().manual_seed(1))
    mask = torch.tensor([1.0, 1.0, 1.0, 0.0])
    target = torch.eye(2)[torch.tensor([0, 1, 1, 0])]
    drop = model.dropout_masks(torch.Generator().manual_seed(9), 4 * S, "cpu")
    gen = torch.Generator().manual_seed(9)
    with bn_row_mask(mask.repeat_interleave(S)):
        out = net(x, False, gen)
    loss = losses.bce_with_logits(out, target, mask)
    grads = torch.autograd.grad(loss, list(net.parameters()))
    net_ref = networks.load("cnn_linear")
    ref_loss, ref_grads = runs.samples_loss_grads(net_ref, w, x, target, mask,
                                                  drop)
    ref_logits = net_ref.logits(w, model.features(w, x, False, drop, mask))
    assert torch.allclose(out, ref_logits, atol=1e-5)
    assert abs(float(loss.detach()) - float(ref_loss)) < 1e-6
    for (name, _), g in zip(net.named_parameters(), grads):
        assert torch.allclose(g, ref_grads[name], atol=1e-5, rtol=1e-4), name


def test_nested_blocks_equal_the_port_step():
    """Three nested SGD steps of the port's own step function against the
    reference's in blocks of 4 windows, each patient padded to its bucket
    in the port and left unpadded in the reference."""
    w = weights_lib.make_weights("cnn_to_nested_lstm", S, 6, "cpu")
    net = port_model("cnn_to_nested_lstm", w)
    opt = make_optimizer(net.parameters(), clip_grad=True, clip_val=0.01)
    state = TrainState(net, opt, torch.Generator().manual_seed(21))
    train_step, _ = make_nested_steps(losses.bce_with_logits)
    rng = torch.Generator().manual_seed(2)
    raw = torch.randn(30, S, 1, 224, generator=rng)
    targets = torch.eye(2)[torch.tensor([1] * 30)]
    steps = [list(range(0, 11)), list(range(11, 20)), list(range(20, 30))]
    want = runs.train_steps(
        "cnn_to_nested_lstm", w, raw, targets, steps, np.zeros(1),
        np.ones(1), 21, [folds.bucket(len(s)) * S for s in steps],
        {"lr": 1e-3, "weight_decay": 1e-4, "clip": 0.01}, block=4)
    got = []
    for ids in steps:
        size = folds.bucket(len(ids))
        data = torch.zeros(1, size, S, 1, 224)
        data[0, :len(ids)] = raw[ids]
        mask = torch.zeros(1, size)
        mask[0, :len(ids)] = 1.0
        got.append(float(train_step(state, data, targets[:1], mask)))
    assert np.allclose(got, want["losses"], atol=1e-6)
    assert_changes(net, w, want["change"])


def test_cnn_linear_step_equals_the_port_step():
    w = weights_lib.make_weights("cnn_linear", S, 7, "cpu")
    net = port_model("cnn_linear", w)
    opt = make_optimizer(net.parameters(), clip_grad=True, clip_val=0.01)
    state = TrainState(net, opt, torch.Generator().manual_seed(4))
    train_step, _ = make_train_step(losses.bce_with_logits)
    raw = torch.randn(12, S, 1, 224, generator=torch.Generator().manual_seed(3))
    targets = torch.eye(2)[torch.tensor([0, 1] * 6)]
    steps = [[0, 1, 2, 3], [4, 5, 6, 7], [8, 9, 10, 11]]
    want = runs.train_steps(
        "cnn_linear", w, raw, targets, steps, np.zeros(1), np.ones(1), 4,
        4 * S, {"lr": 1e-3, "weight_decay": 1e-4, "clip": 0.01})
    got = [float(train_step(state, raw[ids], targets[ids], torch.ones(4)))
           for ids in steps]
    assert np.allclose(got, want["losses"], atol=1e-6)
    assert_changes(net, w, want["change"])


def test_nested_test_logits_equal_the_port_eval_step():
    """A nested test epoch: the port's eval step over each patient padded
    to its bucket, dropout drawn over the bucket, against the
    reference's test logits of the real windows alone (blocks of 4)."""
    w = weights_lib.make_weights("cnn_to_nested_lstm", S, 8, "cpu")
    net = port_model("cnn_to_nested_lstm", w)
    opt = make_optimizer(net.parameters(), clip_grad=True, clip_val=0.01)
    state = TrainState(net, opt, torch.Generator().manual_seed(23))
    _, eval_step = make_nested_steps(losses.bce_with_logits)
    raw = torch.randn(30, S, 1, 224,
                      generator=torch.Generator().manual_seed(5))
    targets = torch.eye(2)[torch.tensor([0] * 11 + [1] * 19)]
    steps = [list(range(0, 11)), list(range(11, 30))]
    masks = [np.ones(len(s), np.float32) for s in steps]
    want, want_losses = runs.test_logits(
        "cnn_to_nested_lstm", w, raw, targets, steps, masks, np.zeros(1),
        np.ones(1), 23, [folds.bucket(len(s)) * S for s in steps], block=4)
    for ids, ref, ref_loss in zip(steps, want, want_losses):
        size = folds.bucket(len(ids))
        data = torch.zeros(1, size, S, 1, 224)
        data[0, :len(ids)] = raw[ids]
        mask = torch.zeros(1, size)
        mask[0, :len(ids)] = 1.0
        loss, out = eval_step(state, data, targets[ids[:1]], mask)
        assert torch.allclose(out[0, :len(ids)], ref, atol=1e-5)
        assert abs(float(loss) - ref_loss) < 1e-6


@pytest.mark.parametrize("network,train,gflop", [
    ("cnn_linear", True, 0.668), ("cnn_linear", False, 0.223),
    ("cnn_to_nested_lstm", True, 0.669)])
def test_flops_per_window(network, train, gflop):
    got = flops.flops_per_window(network, 20, train) / 1e9
    assert round(got, 3) == gflop
