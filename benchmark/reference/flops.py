"""The model FLOPs of a window, counted once on the plain reference.

``torch.utils.flop_counter.FlopCounterMode`` counts the convolutions and
matrix products of the network's reference forward (the backbone, then
its module's ``logits``), and for training its backward too, on the meta
device, so no memory is touched and the count follows from the shapes
alone.  The count never reads the measured program, so a rewritten
kernel cannot move its own yardstick.
"""
import torch
from torch.utils.flop_counter import FlopCounterMode

from benchmark.reference import model, networks


def flops_per_window(network, n_sub_batches, train, windows=16):
    """Model FLOPs of one window: a batch of ``windows`` samples or one
    patient of ``windows`` windows, as the network's step holds them,
    divided by ``windows``; forward and backward for ``train``, forward
    alone otherwise."""
    net = networks.load(network)
    params = {name: torch.zeros(shape, device="meta", requires_grad=True)
              for name, shape, _ in net.param_spec(n_sub_batches)}
    x = torch.zeros((windows, n_sub_batches, 1, model.WINDOW), device="meta")
    target = torch.zeros((windows, 2), device="meta")
    with FlopCounterMode(display=False) as counter:
        with torch.set_grad_enabled(train):
            feats = model.features(params, x, net.STEP == "patient")
            logits = net.logits(params, feats)
            if train:
                loss = model.bce(logits, target)
                torch.autograd.grad(loss, list(params.values()))
    return counter.get_total_flops() / windows
