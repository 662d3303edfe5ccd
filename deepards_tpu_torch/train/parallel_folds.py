"""Parallel-fold training: every k-fold fold trains at once.

Counterpart of ``deepards_tpu/train/parallel_folds.py``.  Each parameter
is stacked over the folds, (F, ...), each fold from its own
initialization.  One step gathers a batch for every fold on the device
and runs the fold step under ``torch.func.vmap`` (``functional_call`` of
one template model over each fold's slice; dropout masks drawn per fold,
``randomness="different"``); the backward of the folds' summed losses
gives each fold its own gradient, since no fold reads another's params.
Clip, weight decay, SGD and Adam are elementwise, so one optimizer over
the stacked tensors updates each fold as its own optimizer would.  On the
card the stacked train and eval steps are CUDA-graph replays.

As in the JAX package: each fold normalizes by its own (mu, std) (the
padded-breath rule for padded dataset types; no filters); its norms see
only its real rows; an epoch has the fewest steps of any fold (the
shuffled tail of the longer folds is dropped), each fold's order a
permutation from the host generator, drawn fold by fold; evaluation runs
every fold to the longest split with pad rows masked.  Its forward draws
dropout masks as the sequential trainer's eval does: as in training but
for a network evaluated with dropout off (cnn_lstm), where the JAX
package's parallel eval keeps dropout on.  Checkpoints are per-fold slices
in the sequential path's layout and names, each with its fold's scaling
sidecar; a resume is at an epoch, one checkpoint seeding every fold.
"""
import numpy as np
import torch
from torch import nn

from deepards_tpu_torch.data.pipeline import transform_batch
from deepards_tpu_torch.models.layers import bn_row_mask
from deepards_tpu_torch.parallel import mesh
from deepards_tpu_torch.train import checkpoint
from deepards_tpu_torch.train.loop import Trainer
from deepards_tpu_torch.train.steps import (
    StepRunner,
    TrainState,
    make_optimizer,
)


class StackedParams(nn.Module):
    """A template model's parameters stacked over F folds: ``params[k]``
    is (F,) + the shape of the template's k-th parameter ``names[k]``."""

    def __init__(self, names, tensors):
        super().__init__()
        self.names = list(names)
        self.params = nn.ParameterList(
            [nn.Parameter(t) for t in tensors])

    def as_dict(self):
        return dict(zip(self.names, self.params))

    def fold_state_dict(self, fold):
        return {n: p.detach()[fold] for n, p in zip(self.names, self.params)}


class _Held:
    """A state dict in the place of a model or an optimizer."""

    def __init__(self, state):
        self._state = state

    def state_dict(self):
        return self._state


def make_fold_steps(model, loss_fn, mus, stds, is_padded=False,
                    compute_dtype=None, target_mode="per_sample",
                    dropout_active=True, eval_dropout_active=None):
    """(train_step, eval_step) over fold-stacked batches, each called as
    ``(state, data (F, B, S, C, L), target (F, B, T), mask (F, B))`` with
    ``state.model`` a ``StackedParams``.  The train step returns the (F,)
    losses, the eval step the losses and the (F, B, ...) outputs.  Eval
    draws dropout masks as ``eval_dropout_active`` says (default: as in
    training)."""
    if eval_dropout_active is None:
        eval_dropout_active = dropout_active

    def fold_forward(params, data, target, mask, mu, std, generator,
                     active):
        data = transform_batch(data, mu, std, is_padded=is_padded)
        if compute_dtype is not None:
            data = data.to(compute_dtype)
            params = {k: v.to(compute_dtype) for k, v in params.items()}
        rows = mask[:, None].expand(-1, data.shape[1]).reshape(-1)
        with bn_row_mask(rows):
            out = torch.func.functional_call(
                model, params, (data, not active, generator))
        if isinstance(out, tuple):
            out = out[0]
        if compute_dtype is not None:
            out = out.float()
        if target_mode == "per_breath":
            target = target[:, None, :].expand(-1, out.shape[1], -1)
        return loss_fn(out, target, mask), out

    def run(state, data, target, mask, active):
        forward = torch.func.vmap(
            lambda p, d, t, m, mu, std: fold_forward(
                p, d, t, m, mu, std, state.generator, active),
            randomness="different")
        return forward(state.model.as_dict(), data, target, mask, mus, stds)

    def train_step(state, data, target, mask):
        losses, _ = run(state, data, target, mask, dropout_active)
        state.optimizer.zero_grad()
        losses.sum().backward()
        state.optimizer.step()
        state.step += 1
        return losses.detach()

    @torch.no_grad()
    def eval_step(state, data, target, mask):
        return run(state, data, target, mask, eval_dropout_active)

    return train_step, eval_step


class ParallelFoldTrainer(Trainer):
    """All k folds of a standard classifier trained at once."""

    shards_batches = False  # the stacked folds run whole on every rank

    def train_and_test(self):
        conf = self.conf
        if not conf.get("kfolds"):
            raise ValueError("parallel_folds requires kfold mode")
        if self.spec.kind != "classifier" or self.spec.trainer != "standard":
            raise ValueError(
                "parallel_folds supports standard classifier networks")
        if self.spec.super_batch:
            # the JAX package's parallel folds feed it batches of windows
            # as if each were a patient and fail recording its eval
            raise ValueError(
                "parallel_folds: {} trains whole-patient super batches "
                "(the nested trainer), not batches of windows".format(
                    conf.network))
        self.resume_meta = None
        if conf.get("load_checkpoint"):
            self.resume_meta = checkpoint.load_resume_meta(
                conf.load_checkpoint)
        if self.resume_meta and "host_rng" in self.resume_meta:
            self.host_rng.bit_generator.state = self.resume_meta["host_rng"]
        train_dataset, test_dataset = self.get_base_datasets()
        n_folds = self.n_kfolds
        self.fold_train_idx, self.fold_test_idx, scaling = [], [], []
        for f in range(n_folds):
            train_dataset.set_kfold_indexes_for_fold(f)
            self.fold_train_idx.append(
                np.asarray(train_dataset.current_indices()))
            test_dataset.set_kfold_indexes_for_fold(f)
            self.fold_test_idx.append(
                np.asarray(test_dataset.current_indices()))
            scaling.append(train_dataset.scaling_factors[f])
        self.scaling = [(np.asarray(mu, np.float32),
                         np.asarray(std, np.float32)) for mu, std in scaling]
        state = self.new_stacked_state(n_folds)
        if conf.get("load_checkpoint"):
            self.restore_stacked(state, conf.load_checkpoint)
        mesh.replicate_tree(state.model.parameters())
        runner = self.make_stacked_runner(state, train_dataset)
        epochs = conf.get("epochs", 10)
        start_epoch = self.resume_meta["epoch"] if self.resume_meta else 1
        with self.deferred_fetch():
            for epoch_num in range(start_epoch, epochs + 1):
                if not conf.get("no_train"):
                    self.run_stacked_train_epoch(runner, train_dataset,
                                                 epoch_num)
                if not conf.get("no_test_after_epochs") or epoch_num == epochs:
                    self.run_stacked_test_epoch(runner, test_dataset,
                                                epoch_num)
                if conf.get("save_model_per_epoch") and conf.get("save_model"):
                    self.save_fold_checkpoints(state, epoch_num)
        if conf.get("save_model"):
            self.save_fold_checkpoints(state, None)
        self.resume_meta = None
        self.final_state = state
        self.perform_post_modeling_actions()
        self.perform_plotting(test_dataset)
        return self.results

    # -- state ----------------------------------------------------------------

    def new_stacked_state(self, n_folds):
        """Each fold's model initialized as the sequential path's fold
        (``init_model``), stacked; one optimizer over the stacked params
        and one dropout generator for all folds."""
        conf = self.conf
        self.template = self.build_model().to(self.device)
        names = [n for n, _ in self.template.named_parameters()]
        inits = []
        for f in range(n_folds):
            model = self.build_model()
            self.init_model(model, f)
            inits.append(dict(model.named_parameters()))
        stacked = StackedParams(names, [
            torch.stack([fold[n].detach() for fold in inits])
            for n in names]).to(self.device)
        optimizer = make_optimizer(
            stacked.parameters(), optimizer=conf.get("optimizer", "sgd"),
            learning_rate=conf.get("learning_rate", 0.001),
            weight_decay=conf.get("weight_decay", 0.0001),
            clip_grad=bool(conf.get("clip_grad")),
            clip_val=conf.get("clip_val", 0.01))
        generator = torch.Generator(device=self.device).manual_seed(
            self._fold_seed(0, 1))
        return TrainState(stacked, optimizer, generator)

    def restore_stacked(self, state, path):
        """One checkpoint of the sequential layout into every fold: params,
        optimizer state, generator and step."""
        saved = checkpoint.restore(path)
        n_folds = len(self.fold_train_idx)
        with torch.no_grad():
            for name, p in zip(state.model.names, state.model.params):
                p.copy_(saved["params"][name].expand_as(p))
        if "opt_state" in saved:
            opt = saved["opt_state"]
            opt["state"] = {k: {n: (v.expand((n_folds,) + v.shape).clone()
                                    if torch.is_tensor(v) and v.ndim else v)
                                for n, v in s.items()}
                            for k, s in opt["state"].items()}
            state.optimizer.load_state_dict(opt)
        if "rng" in saved:
            state.generator.set_state(saved["rng"])
        state.step = saved.get("step", 0)

    def make_stacked_runner(self, state, dataset, dropout=True,
                            graphed=None):
        """The stacked steps over ``dataset``'s cache shape: CUDA-graph
        replays on the card unless ``graphed`` says otherwise; ``dropout``
        False turns it off."""
        conf = self.conf
        batch_size = conf.get("batch_size", 16)
        n_folds = len(self.fold_train_idx)
        mus, stds = (torch.as_tensor(np.stack(x)).to(self.device)
                     for x in zip(*self.scaling))
        train_step, eval_step = make_fold_steps(
            self.template, self.loss_fn, mus, stds,
            is_padded="padded_breath_by_breath" in dataset.dataset_type,
            compute_dtype=self.compute_dtype,
            target_mode=self.spec.target_mode, dropout_active=dropout,
            eval_dropout_active=dropout and not self.spec.eval_dropout_off)
        cache = dataset.cache
        extra = {
            "target": torch.zeros((n_folds, batch_size)
                                  + cache.target.shape[1:],
                                  device=self.device),
            "mask": torch.ones(n_folds, batch_size, device=self.device)}
        if graphed is None:
            graphed = self.device.type == "cuda"
        return StepRunner(state, train_step, eval_step,
                          (n_folds, batch_size) + cache.data.shape[1:],
                          graphed=graphed, extra_inputs=extra)

    # -- epochs ---------------------------------------------------------------

    def stacked_steps(self, runner, dataset, ids, masks, train):
        """One stacked step per (F, B) block of ``ids``: every fold's batch
        gathered on the device into the runner's buffers.  Returns the
        (steps, F) losses and, for eval, the (steps, F, B, ...) outputs."""
        dev = self._get_device_cache(dataset)
        ids = torch.from_numpy(ids).to(self.device)
        masks = torch.from_numpy(masks).to(self.device)
        inputs = runner.inputs
        flat = {k: inputs[k].view((-1,) + inputs[k].shape[2:])
                for k in ("data", "target")}
        steps = ids.shape[0]
        losses = torch.empty((steps, ids.shape[1]), device=self.device)
        outs = None
        for i in range(steps):
            rows = ids[i].reshape(-1)
            for key in ("data", "target"):
                torch.index_select(dev[key], 0, rows, out=flat[key])
            inputs["mask"].copy_(masks[i])
            if train:
                losses[i] = runner.train()
            else:
                losses[i], out = runner.eval()
                if outs is None:
                    outs = out.new_empty((steps,) + tuple(out.shape))
                outs[i] = out
        return losses, outs

    def run_stacked_train_epoch(self, runner, dataset, epoch_num):
        """Each fold's permutation (drawn in fold order), cut to the
        fewest full batches of any fold; with a fold shorter than a batch,
        one step of each fold's first batch_size windows, pad rows
        masked."""
        batch_size = self.conf.get("batch_size", 16)
        orders = [self.host_rng.permutation(idx)
                  for idx in self.fold_train_idx]
        n_steps = min(len(o) for o in orders) // batch_size
        if n_steps:
            ids = np.stack([o[:n_steps * batch_size].reshape(
                n_steps, batch_size) for o in orders], axis=1)
            masks = np.ones(ids.shape, np.float32)
        else:
            ids = np.stack([np.resize(o[:batch_size], batch_size)
                            for o in orders])[None]
            masks = np.stack([np.arange(batch_size) < len(o)
                              for o in orders])[None].astype(np.float32)
        if self.verbose:
            print("train steps: {} x {} folds (parallel folds)".format(
                len(ids), len(orders)))
        losses, _ = self.stacked_steps(runner, dataset, ids, masks, True)
        self._defer(self._record_stacked_train, losses, epoch_num)

    def _record_stacked_train(self, losses, epoch_num):
        for row in losses.cpu().numpy():
            for f, loss in enumerate(row):
                self.results.update_meter(
                    "loss_epoch_{}".format(epoch_num), f, float(loss))
                self.results.update_loss(f, float(loss))

    def run_stacked_test_epoch(self, runner, dataset, epoch_num):
        """Every fold to the longest test split, shorter splits padded with
        masked rows."""
        batch_size = self.conf.get("batch_size", 16)
        fold_idx = self.fold_test_idx
        n_steps = -(-max(len(idx) for idx in fold_idx) // batch_size)
        ids = np.zeros((n_steps, len(fold_idx), batch_size), np.int64)
        masks = np.zeros(ids.shape, np.float32)
        for f, idx in enumerate(fold_idx):
            n = len(idx)
            padded = np.full(n_steps * batch_size, idx[0] if n else 0)
            padded[:n] = idx
            ids[:, f] = padded.reshape(n_steps, batch_size)
            valid = np.zeros(n_steps * batch_size, np.float32)
            valid[:n] = 1.0
            masks[:, f] = valid.reshape(n_steps, batch_size)
        losses, outs = self.stacked_steps(runner, dataset, ids, masks, False)
        self._defer(self._record_stacked_eval, losses, outs, dataset,
                    epoch_num)

    def _record_stacked_eval(self, losses, outs, dataset, epoch_num):
        """Per fold: a test loss for each step holding one of its windows,
        then its windows' predictions (a per-breath head's index repeated
        S times) to the votes."""
        losses = losses.cpu().numpy()
        outs = outs.cpu().numpy()
        batch_size = outs.shape[2]
        self.last_eval = {}
        for f, idx in enumerate(self.fold_test_idx):
            n = len(idx)
            if n == 0:
                continue
            for s in range(-(-n // batch_size)):
                self.results.update_meter("test_loss", f, float(losses[s, f]))
            out = outs[:, f].reshape((-1,) + outs.shape[3:])[:n]
            self.last_eval[f] = {"index": idx, "logits": out}
            preds = out.argmax(axis=-1)
            pred_idx = idx
            if self.spec.expand_obs_idx and out.ndim == 3:
                pred_idx = np.repeat(idx, out.shape[1])
                preds = preds.reshape(-1)
            dataset.set_kfold_indexes_for_fold(f)
            self.record_classifier_results(preds, pred_idx, dataset, f,
                                           epoch_num)

    # -- checkpoints ----------------------------------------------------------

    def save_fold_checkpoints(self, state, epoch_num):
        """Each fold's slice in the sequential path's layout and name, with
        its fold's scaling sidecar."""
        opt = state.optimizer.state_dict()
        for f in range(len(self.fold_train_idx)):
            opt_f = dict(opt, state={
                k: {n: (v[f] if torch.is_tensor(v) and v.ndim else v)
                    for n, v in s.items()}
                for k, s in opt["state"].items()})
            self._current_scaling = self.scaling[f]
            self.save_checkpoint(
                TrainState(_Held(state.model.fold_state_dict(f)),
                           _Held(opt_f), state.generator, state.step),
                f, epoch_num)
