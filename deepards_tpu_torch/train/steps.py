"""Train and eval steps, the optimizer, and the steps as CUDA graphs.

Counterpart of ``deepards_tpu/train/steps.py``.  ``make_train_step``
gives the JAX package's jitted step as eager PyTorch: normalize the batch,
forward (with the row mask scoped for ``BatchStatNorm`` and the loss),
backward, clamp every gradient element, optimizer step.  The params, the
optimizer state and the dropout generator live in a ``TrainState`` and
change in place.

``StepRunner`` runs those steps over static input buffers.  On the card it
captures one train step and one eval step as CUDA graphs and replays them:
the counterpart of the JAX package's ``train_scan``/``eval_scan``, which
run many steps in one dispatch, since an eager step is host-bound (~1,450
kernel launches, the card idle most of the step).  On the CPU, or when the
caller asks, it calls the eager steps on the same buffers.
"""
from dataclasses import dataclass
from typing import Callable, Optional

import torch
from torch import nn

from deepards_tpu_torch.models.layers import bn_row_mask
from deepards_tpu_torch.parallel import mesh
from deepards_tpu_torch.utils import profiling


class ClippedOptimizer:
    """``optax.chain(clip(clip_val), add_decayed_weights(wd),
    sgd(lr, momentum=0.9, nesterov=True))`` in torch.

    Each gradient element is clamped to +-clip_val first (no norm clip),
    then ``torch.optim.SGD``'s coupled weight decay adds wd * param before
    the Nesterov momentum.  Its momentum buffer starts as the first
    decayed gradient, which equals optax's trace started from zeros.
    ``adam`` is ``torch.optim.Adam`` with no decay, as optax.adam in the
    JAX chain; on the card it keeps its step count on the device
    (``capturable``), so a CUDA graph can hold its update.  Inside
    ``mesh.sharded_rows`` the gradients are summed over the ranks before
    the clamp.
    """

    def __init__(self, params, optimizer="sgd", learning_rate=0.001,
                 weight_decay=0.0001, clip_grad=False, clip_val=0.01):
        self.params = list(params)
        if optimizer == "sgd":
            self.optimizer = torch.optim.SGD(
                self.params, lr=learning_rate, momentum=0.9, nesterov=True,
                weight_decay=weight_decay)
        elif optimizer == "adam":
            self.optimizer = torch.optim.Adam(
                self.params, lr=learning_rate,
                capturable=self.params[0].is_cuda)
        else:
            raise ValueError("unknown optimizer: {}".format(optimizer))
        self.clip_val = clip_val if clip_grad else None

    def zero_grad(self):
        self.optimizer.zero_grad(set_to_none=True)

    def step(self):
        grads = [p.grad for p in self.params if p.grad is not None]
        mesh.sum_gradients(grads)
        if self.clip_val is not None:
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
    target_mode: str = "per_sample",
    bn_mask_rows: str = "windows",
):
    """(train_step, eval_step), each called as ``(state, data, target,
    mask, meta=None)`` with raw (B, S, C, L) data (or (B, C, H, W)
    images), (B, T) targets, the (B,) row mask and, for a head with a
    metadata input, (B, S, M) metadata, all on the model's device.

    target_mode: how the model's output meets the target
    (``deepards_tpu/train/steps.py:196-197``): 'per_sample', (B, 2)
    logits against (B, 2) targets; 'per_breath', (B, S, 2) logits against
    the target repeated over the S windows; 'regression', (B, T)
    predictions against (B, T) targets; 'autoencoder', the (B, S, C, L)
    reconstruction against the normalized input in the compute dtype,
    cast to (at least) float32 (``deepards_tpu/train/steps.py:198``).  A
    stateful head's ``(logits, carry)`` output is reduced to its logits.

    transform: the normalization applied to the raw data on the device.
    compute_dtype: params and data are cast to it for the forward and the
    logits back to float32 for the loss; the cast is inside autograd, so
    grads reach the float32 master params.
    bn_mask_rows: 'windows' repeats the row mask S times for
    ``BatchStatNorm``, whose rows are the B*S windows; 'batch' gives it
    as it is, for images, whose backbone rows are the B images
    (``deepards_tpu/train/steps.py:160-176``).  The mask weights the loss
    as it is.
    Eval runs under ``torch.no_grad`` with dropout as
    ``eval_dropout_active`` says (default: as in training), drawing its
    masks from the same generator, so each eval advances it.
    Neither step reads a value back to the host, so both can be captured
    in a CUDA graph.
    """
    if target_mode not in ("per_sample", "per_breath", "regression",
                           "autoencoder"):
        raise ValueError("unknown target_mode: {}".format(target_mode))
    if bn_mask_rows not in ("windows", "batch"):
        raise ValueError("unknown bn_mask_rows: {}".format(bn_mask_rows))
    if eval_dropout_active is None:
        eval_dropout_active = dropout_active

    def loss_wrap(state, data, target, mask, meta, active):
        if transform is not None:
            data = transform(data)
        model = state.model
        if compute_dtype is not None:
            data = data.to(compute_dtype)
            params = {name: p.to(compute_dtype)
                      for name, p in model.named_parameters()}

            def apply(x):
                return torch.func.functional_call(
                    model, params, (x, not active, state.generator, meta))
        else:
            def apply(x):
                return model(x, not active, state.generator, meta)
        rows = mask
        if bn_mask_rows == "windows":
            # (B,) -> (B*S,): each sample's mask once per window, as
            # repeat_interleave would, without its host sync
            rows = mask[:, None].expand(-1, data.shape[1]).reshape(-1)
        with bn_row_mask(rows):
            out = apply(data)
        if isinstance(out, tuple):
            out = out[0]  # a stateful head's (logits, carry)
        if compute_dtype is not None:
            out = out.float()
        if target_mode == "per_breath":
            target = target[:, None, :].expand(-1, out.shape[1], -1)
        elif target_mode == "autoencoder":
            target = data.to(torch.promote_types(data.dtype, torch.float32))
        return loss_fn(out, target, mask), out

    def train_step(state, data, target, mask, meta=None):
        loss, _ = loss_wrap(state, data, target, mask, meta, dropout_active)
        state.optimizer.zero_grad()
        loss.backward()
        state.optimizer.step()
        state.step += 1
        return mesh.global_sum(loss.detach())

    @torch.no_grad()
    def eval_step(state, data, target, mask, meta=None):
        loss, out = loss_wrap(state, data, target, mask, meta,
                              eval_dropout_active)
        return mesh.global_sum(loss), out

    return train_step, eval_step


class StepRunner:
    """A fold's train and eval steps over static input buffers.

    ``inputs`` holds one batch: ``data`` (B, S, C, L), ``target`` (B,
    ``target_width``), ``mask`` (B,) and, with ``meta_shape``, ``meta``;
    ``extra_inputs`` adds buffers of the caller's (or replaces these):
    the stateful fold's LSTM carry, the fold-stacked batch of parallel
    folds.  The caller fills them in place (``copy_``,
    ``index_select(out=...)``) and then calls ``train()`` (the loss) or
    ``eval()`` (the loss and the model's output: (B, 2) logits, (B, S, 2)
    for a per-breath head, (B, T) for a regressor).  What these return
    may be the graph's static outputs: copy it out before the next call.
    A step may write its inputs in place (the carry it hands on).
    ``eval_step`` None: a runner of train steps only.  Each call is a
    ``deepards.step.run`` span, and on the card each replay lies between
    ``profiling.step_events``.

    graphed: capture each step as a ``torch.cuda.CUDAGraph``.  A few
    eager steps on a side stream come first, as capture asks, with
    host syncs made errors (a sync cannot be captured); they change the
    params, the optimizer state and the generator, so those are restored
    in place afterwards, and optimizer state that the warm-up created
    lazily is zeroed: a zero SGD momentum buffer gives 0 * 0.9 + g = g
    at the first step, what torch's first step clones, and zero Adam
    moments and step count are Adam's fresh state; the input buffers are
    restored too.  The generator is registered with the graphs, so every
    replay draws new dropout masks and advances it as an eager step does.  Capture binds the tensors it
    reads: the params, the optimizer state and the buffers must be
    changed in place from then on.  A capture that fails raises.
    ``axis``: the run's ``mesh.DataAxis``; when it is sharded over
    processes the buffers hold this rank's rows, each step runs eagerly
    within ``mesh.sharded_rows`` (a graph cannot capture gloo's
    collectives), and its loss is the whole batch's.
    ``pool``: a ``torch.cuda.graph_pool_handle()`` whose memory the graphs
    share with other runners' graphs (one step runs at a time, and what
    a step returns is copied out before the next), in place of a private
    pool per graph.
    """

    WARMUP_STEPS = 3  # eager steps before a capture

    def __init__(self, state, train_step, eval_step, data_shape,
                 target_width=2, meta_shape=None, graphed=False,
                 extra_inputs=None, pool=None, axis=None):
        self.state = state
        self.axis = axis
        self.pool = pool
        self._train_step = train_step
        self._eval_step = eval_step
        device = next(state.model.parameters()).device
        batch = data_shape[0]
        self.inputs = {
            "data": torch.zeros(data_shape, device=device),
            "target": torch.zeros(batch, target_width, device=device),
            "mask": torch.ones(batch, device=device),
        }
        if meta_shape is not None:
            self.inputs["meta"] = torch.zeros(meta_shape, device=device)
        self.inputs.update(extra_inputs or {})
        self.graphs = None
        if graphed:
            if device.type != "cuda":
                raise ValueError("CUDA graphs need the model on a CUDA "
                                 "device, not {}".format(device))
            if axis is not None and axis.sharded:
                raise ValueError("a step sharded over processes runs its "
                                 "gloo collectives eagerly: no CUDA graph")
            self._capture()

    def train(self):
        with profiling.annotate("deepards.step.run"):
            if self.graphs is None:
                with mesh.sharded_rows(self.axis):
                    return self._train_step(self.state, **self.inputs)
            self._replay("train")
            self.state.step += 1
            return self._train_loss

    def eval(self):
        with profiling.annotate("deepards.step.run"):
            if self.graphs is None:
                with mesh.sharded_rows(self.axis):
                    return self._eval_step(self.state, **self.inputs)
            self._replay("eval")
            return self._eval_loss, self._eval_out

    def _replay(self, name):
        """Replay a graph between the step events."""
        pair = profiling.step_events.begin()
        try:
            self.graphs[name].replay()
        finally:
            profiling.step_events.end(pair)

    def _capture(self):
        state = self.state
        params = list(state.model.parameters())
        saved_params = [p.detach().clone() for p in params]
        opt_state = state.optimizer.optimizer.state
        saved_opt = {id(p): {k: v.clone() for k, v in s.items()
                             if torch.is_tensor(v)}
                     for p, s in opt_state.items()}
        saved_rng = state.generator.get_state()
        saved_step = state.step
        saved_inputs = {k: v.clone() for k, v in self.inputs.items()}

        side = torch.cuda.Stream()
        side.wait_stream(torch.cuda.current_stream())
        sync_mode = torch.cuda.get_sync_debug_mode()
        torch.cuda.set_sync_debug_mode("error")
        try:
            with torch.cuda.stream(side):
                for _ in range(self.WARMUP_STEPS):
                    self._train_step(state, **self.inputs)
                    if self._eval_step is not None:
                        self._eval_step(state, **self.inputs)
        finally:
            torch.cuda.set_sync_debug_mode(sync_mode)
        torch.cuda.current_stream().wait_stream(side)

        with torch.no_grad():
            for p, v in zip(params, saved_params):
                p.copy_(v)
            for p, s in opt_state.items():
                before = saved_opt.get(id(p), {})
                for k, v in s.items():
                    if torch.is_tensor(v):
                        if k in before:
                            v.copy_(before[k])
                        else:
                            v.zero_()
            for k, v in saved_inputs.items():
                self.inputs[k].copy_(v)
        state.generator.set_state(saved_rng)
        state.optimizer.zero_grad()  # grads are allocated by the capture
        # the warm-up's cached blocks cannot serve the graphs' pool
        torch.cuda.empty_cache()

        graphs = {"train": torch.cuda.CUDAGraph()}
        if self._eval_step is not None:
            graphs["eval"] = torch.cuda.CUDAGraph()
        for graph in graphs.values():
            graph.register_generator_state(state.generator)
        with torch.cuda.graph(graphs["train"], pool=self.pool):
            self._train_loss = self._train_step(state, **self.inputs)
        if self._eval_step is not None:
            with torch.cuda.graph(graphs["eval"], pool=self.pool):
                self._eval_loss, self._eval_out = self._eval_step(
                    state, **self.inputs)
        state.step = saved_step
        self.graphs = graphs
