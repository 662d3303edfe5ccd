"""Train and eval steps and the optimizer.

Counterpart of ``deepards_tpu/train/steps.py``.  A step is the JAX
package's jitted step run eagerly on the device: normalize the batch,
forward (with the row mask scoped for ``BatchStatNorm`` and the loss),
backward, clamp every gradient element, optimizer step.  The params, the
optimizer state and the dropout generator live in a ``TrainState`` and
change in place.
"""
from dataclasses import dataclass
from typing import Callable, Optional

import torch
from torch import nn

from deepards_tpu_torch.models.layers import bn_row_mask


class ClippedOptimizer:
    """``optax.chain(clip(clip_val), add_decayed_weights(wd),
    sgd(lr, momentum=0.9, nesterov=True))`` in torch.

    Each gradient element is clamped to +-clip_val first (no norm clip),
    then ``torch.optim.SGD``'s coupled weight decay adds wd * param before
    the Nesterov momentum.  Its momentum buffer starts as the first
    decayed gradient, which equals optax's trace started from zeros.
    ``adam`` is ``torch.optim.Adam`` with no decay, as optax.adam in the
    JAX chain.
    """

    def __init__(self, params, optimizer="sgd", learning_rate=0.001,
                 weight_decay=0.0001, clip_grad=False, clip_val=0.01):
        self.params = list(params)
        if optimizer == "sgd":
            self.optimizer = torch.optim.SGD(
                self.params, lr=learning_rate, momentum=0.9, nesterov=True,
                weight_decay=weight_decay)
        elif optimizer == "adam":
            self.optimizer = torch.optim.Adam(self.params, lr=learning_rate)
        else:
            raise ValueError("unknown optimizer: {}".format(optimizer))
        self.clip_val = clip_val if clip_grad else None

    def zero_grad(self):
        self.optimizer.zero_grad(set_to_none=True)

    def step(self):
        if self.clip_val is not None:
            grads = [p.grad for p in self.params if p.grad is not None]
            torch._foreach_clamp_min_(grads, -self.clip_val)
            torch._foreach_clamp_max_(grads, self.clip_val)
        self.optimizer.step()

    def state_dict(self):
        return self.optimizer.state_dict()

    def load_state_dict(self, state):
        self.optimizer.load_state_dict(state)


def make_optimizer(params, optimizer="sgd", learning_rate=0.001,
                   weight_decay=0.0001, clip_grad=False, clip_val=0.01):
    return ClippedOptimizer(params, optimizer, learning_rate, weight_decay,
                            clip_grad, clip_val)


@dataclass
class TrainState:
    """What a step reads and changes: the model's params (in place), the
    optimizer state, the dropout generator (on the model's device) and
    the count of train steps."""

    model: nn.Module
    optimizer: ClippedOptimizer
    generator: torch.Generator
    step: int = 0


def make_train_step(
    loss_fn: Callable,
    transform: Optional[Callable] = None,
    compute_dtype: Optional[torch.dtype] = None,
    dropout_active: bool = True,
    eval_dropout_active: Optional[bool] = None,
):
    """(train_step, eval_step), each called as ``(state, data, target,
    mask)`` with raw (B, S, C, L) data, (B, 2) targets and the (B,) row
    mask on the model's device; the model gives (B, 2) logits.

    transform: the normalization applied to the raw data on the device.
    compute_dtype: params and data are cast to it for the forward and the
    logits back to float32 for the loss; the cast is inside autograd, so
    grads reach the float32 master params.
    The row mask is repeated S times for ``BatchStatNorm``, whose rows
    are the B*S windows, and weights the loss as it is.
    Eval runs under ``torch.no_grad`` with dropout as
    ``eval_dropout_active`` says (default: as in training), drawing its
    masks from the same generator, so each eval advances it.
    """
    if eval_dropout_active is None:
        eval_dropout_active = dropout_active

    def loss_wrap(state, data, target, mask, active):
        if transform is not None:
            data = transform(data)
        model = state.model
        if compute_dtype is not None:
            data = data.to(compute_dtype)
            params = {name: p.to(compute_dtype)
                      for name, p in model.named_parameters()}

            def apply(x):
                return torch.func.functional_call(
                    model, params, (x, not active, state.generator)).float()
        else:
            def apply(x):
                return model(x, not active, state.generator)
        with bn_row_mask(torch.repeat_interleave(mask, data.shape[1])):
            out = apply(data)
        return loss_fn(out, target, mask), out

    def train_step(state, data, target, mask):
        loss, _ = loss_wrap(state, data, target, mask, dropout_active)
        state.optimizer.zero_grad()
        loss.backward()
        state.optimizer.step()
        state.step += 1
        return loss.detach()

    @torch.no_grad()
    def eval_step(state, data, target, mask):
        return loss_wrap(state, data, target, mask, eval_dropout_active)

    return train_step, eval_step
