"""Whole-patient "super batch" training for the nested networks.

Counterpart of ``deepards_tpu/train/nested_trainer.py``: a step is all of
one patient's windows, (1, W, S, C, L).  Patients are the ground truth's
grouped by id, sorted (as ``groupby("patient")`` sorts them), each with
its windows in the truth's order and its first row's class as the
target; every epoch visits them in ``host_rng.permutation``.  W is
zero-padded to the next power of two (its bucket) and a window mask
marks the real windows: the fold's normalization runs over the pad
windows too, the backbone normalizes each window on its own, the RNN
and LSTM are causal and the transformer masks its keys, so the real
windows' logits are those of the unpadded patient.  The loss is the
window-mask-weighted mean over the windows (``loss_calc: last_breath``:
the last real window's logits alone).  Train and eval both draw dropout,
as the JAX trainer applies the model with ``deterministic`` False in
both.

Each bucket has its own ``StepRunner``, made at the bucket's first use:
on the card its train and eval steps are CUDA graphs captured then, and
all the buckets' graphs share one memory pool, so the fold holds about
one largest step's activations, not one a bucket.  Each patient's
windows are gathered by index from the device cache into the runner's
buffers (a ``deepards.trainer.stage`` span), and its real and pad
windows counted (``windows.real``, ``windows.pad``).
"""
import numpy as np
import torch

from deepards_tpu_torch.data.pipeline import BatchPipeline
from deepards_tpu_torch.models.nested import bucket
from deepards_tpu_torch.train.loop import Trainer
from deepards_tpu_torch.train.steps import StepRunner
from deepards_tpu_torch.utils import profiling


def patient_groups(dataset):
    """[(patient, window indices, class)] sorted by patient id, each
    patient's indices in the truth's order and its first row's class."""
    truth = dataset.get_ground_truth()
    groups = []
    for patient in sorted(set(truth.patient.tolist())):
        rows = truth.patient == patient
        groups.append((patient, truth.index[rows], int(truth.y[rows][0])))
    return groups


def make_nested_steps(loss_fn, transform=None, compute_dtype=None,
                      last_breath=False, dropout_active=True):
    """(train_step, eval_step), each called as ``(state, data, target,
    mask)`` with one patient's (1, W, S, C, L) raw windows, its (1, 2)
    target and the (1, W) window mask.  The transform normalizes the W
    windows as a batch.  The eval step returns the loss and the (1, W, 2)
    logits.  Neither reads a value back to the host, so both can be
    captured in a CUDA graph."""

    def loss_wrap(state, data, target, mask):
        x = data[0]
        if transform is not None:
            x = transform(x)
        model = state.model
        args = (x[None], not dropout_active, state.generator)
        kwargs = {"window_mask": mask > 0}
        if compute_dtype is not None:
            params = {name: p.to(compute_dtype)
                      for name, p in model.named_parameters()}
            args = (args[0].to(compute_dtype),) + args[1:]
            out = torch.func.functional_call(model, params, args, kwargs)
            out = out.float()
        else:
            out = model(*args, **kwargs)
        if last_breath:
            last = torch.clamp(mask[0].sum().long(), min=1) - 1
            logits = out[0].index_select(0, last.reshape(1))
            return loss_fn(logits, target), out
        return loss_fn(out[0], target.expand(out.shape[1], -1), mask[0]), out

    def train_step(state, data, target, mask):
        loss, _ = loss_wrap(state, data, target, mask)
        state.optimizer.zero_grad()
        loss.backward()
        state.optimizer.step()
        state.step += 1
        return loss.detach()

    @torch.no_grad()
    def eval_step(state, data, target, mask):
        return loss_wrap(state, data, target, mask)

    return train_step, eval_step


class BucketRunners:
    """A ``StepRunner`` per bucket of (1, bucket) + ``window_shape``
    batches, made at the bucket's first use; graphed, their graphs share
    one memory pool."""

    def __init__(self, state, train_step, eval_step, window_shape, graphed):
        self.state = state
        self.steps = (train_step, eval_step)
        self.window_shape = tuple(window_shape)
        self.graphed = graphed
        self.pool = torch.cuda.graph_pool_handle() if graphed else None
        self.runners = {}

    def __getitem__(self, size):
        if size not in self.runners:
            device = next(self.state.model.parameters()).device
            self.runners[size] = StepRunner(
                self.state, *self.steps, (1, size) + self.window_shape,
                graphed=self.graphed, pool=self.pool,
                extra_inputs={"mask": torch.ones(1, size, device=device)})
        return self.runners[size]


class NestedTrainer(Trainer):
    """The fold loop over patients; the rest (datasets, records,
    checkpoints, resume at an epoch) is ``Trainer``'s."""

    shards_batches = False  # one patient a step, whole on every rank

    def nested_runners(self, state, transform, window_shape, graphed=None,
                       dropout=True):
        """The fold's ``BucketRunners`` over windows of ``window_shape``
        (S, C, L), each batch normalized by ``transform``; ``graphed``
        None captures on the card."""
        train_step, eval_step = make_nested_steps(
            self.loss_fn, transform=transform,
            compute_dtype=self.compute_dtype,
            last_breath=self.conf.get("loss_calc") == "last_breath",
            dropout_active=dropout)
        if graphed is None:
            graphed = self.device.type == "cuda"
        return BucketRunners(state, train_step, eval_step, window_shape,
                             graphed)

    def run_fold(self, fold_num, train_dataset, test_dataset):
        conf = self.conf
        state = self.fold_state(fold_num)
        runners = self.nested_runners(
            state, BatchPipeline(train_dataset, self.device),
            train_dataset.cache.data.shape[1:])
        groups = patient_groups(train_dataset)
        test_groups = patient_groups(test_dataset)
        epochs = conf.get("epochs", 10)
        resume = self.resume_meta
        if not (resume and resume["fold"] == fold_num):
            resume = None
        start_epoch = resume["epoch"] if resume else 1
        with self.deferred_fetch():
            for epoch_num in range(start_epoch, epochs + 1):
                if not conf.get("no_train"):
                    order = self.host_rng.permutation(len(groups))
                    if conf.get("debug"):
                        order = order[:1]
                    losses, _ = self.patient_steps(
                        runners, train_dataset, [groups[i] for i in order],
                        train=True)
                    self._defer(self._record_nested_losses, losses,
                                fold_num)
                if not conf.get("no_test_after_epochs") or epoch_num == epochs:
                    losses, outs = self.patient_steps(
                        runners, test_dataset, test_groups, train=False)
                    self._defer(self._record_nested_eval, losses, outs,
                                test_groups, test_dataset, fold_num,
                                epoch_num)
                if conf.get("save_model_per_epoch") and conf.get("save_model"):
                    self.save_checkpoint(state, fold_num, epoch_num)
        if conf.get("save_model"):
            self.save_checkpoint(state, fold_num, None)
        if resume:
            self.resume_meta = None
        self.final_state = state
        return state

    def patient_steps(self, runners, dataset, groups, train):
        """One step per patient of ``groups``, its windows gathered on the
        device into its bucket's runner.  Returns the (P,) losses and, for
        eval, each patient's (W, 2) logits, on the device."""
        dev = self._get_device_cache(dataset)
        losses = torch.empty(len(groups), device=self.device)
        targets = torch.from_numpy(np.eye(2, dtype=np.float32)[
            [y for _, _, y in groups]]).to(self.device)
        outs = []
        for i, (_, idxs, _) in enumerate(groups):
            w, size = len(idxs), bucket(len(idxs))
            runner = runners[size]
            profiling.count("windows.real", w)
            profiling.count("windows.pad", size - w)
            inputs = runner.inputs
            with profiling.annotate("deepards.trainer.stage"):
                ids = torch.from_numpy(np.asarray(idxs)).to(self.device)
                torch.index_select(dev["data"], 0, ids,
                                   out=inputs["data"][0, :w])
                inputs["data"][0, w:].zero_()
                inputs["mask"].zero_()
                inputs["mask"][0, :w] = 1.0
                inputs["target"].copy_(targets[i:i + 1])
            if train:
                losses[i] = runner.train()
            else:
                loss, out = runner.eval()
                losses[i] = loss
                outs.append(out[0, :w].clone())
        return losses, outs

    def _record_nested_losses(self, losses, fold_num):
        for loss in losses.cpu().numpy():
            self.results.update_loss(fold_num, float(loss))

    def _record_nested_eval(self, losses, outs, groups, dataset, fold_num,
                            epoch_num):
        """Test losses a patient, then each real window's prediction."""
        for loss in losses.cpu().numpy():
            self.results.update_meter("test_loss", fold_num, float(loss))
        logits = torch.cat(outs).cpu().numpy()
        index = np.concatenate([idxs for _, idxs, _ in groups])
        self.last_eval = {"index": index, "logits": logits}
        self.record_classifier_results(logits.argmax(axis=-1), index,
                                       dataset, fold_num, epoch_num)
