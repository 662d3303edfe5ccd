"""The model FLOPs of a window, counted once on the plain reference.

``torch.utils.flop_counter.FlopCounterMode`` counts the convolutions and
matrix products of the reference's forward (and, for training, of its
backward too) on the meta device, so no memory is touched and the count
follows from the shapes alone.  The count never reads the measured
program, so a rewritten kernel cannot move its own yardstick.
"""
import torch
from torch.utils.flop_counter import FlopCounterMode

from benchmark.reference import model


def _meta_params(network, n_sub_batches):
    return {name: torch.zeros(shape, device="meta", requires_grad=True)
            for name, shape, _ in model.param_spec(network, n_sub_batches)}


def flops_per_window(network, n_sub_batches, train, windows=16):
    """Model FLOPs of one window: a batch of ``windows`` samples
    (cnn_linear) or one patient of ``windows`` windows (nested), divided
    by ``windows``; forward and backward for ``train``, forward alone
    otherwise."""
    params = _meta_params(network, n_sub_batches)
    x = torch.zeros((windows, n_sub_batches, 1, model.WINDOW), device="meta")
    target = torch.zeros((windows, 2), device="meta")
    with FlopCounterMode(display=False) as counter:
        with torch.set_grad_enabled(train):
            if network == "cnn_linear":
                logits = model.cnn_linear_logits(params, x)
            else:
                logits = model.lstm_head(
                    params, model.nested_medians(params, x))
            if train:
                loss = model.bce(logits, target)
                torch.autograd.grad(loss, list(params.values()))
    return counter.get_total_flops() / windows
