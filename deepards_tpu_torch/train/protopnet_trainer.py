"""ProtoPNet training: staged optimizers, the composite loss, the push.

Counterpart of ``deepards_tpu/train/protopnet_trainer.py``, with the
reference's staging (train_ards_detector.py:1158-1192): each stage has
an optimizer of its own over its own parameter group, and only that group
moves.

- warm: the add-on layers and the prototypes;
- joint: the backbone, the add-on layers and the prototypes;
- last: the last layer.

Each stage's step is ``torch.autograd.grad`` of the loss with respect to
its group, then its optimizer's step (Nesterov SGD, momentum 0.9, coupled
weight decay; or Adam); no other parameter gets a gradient or an update.
The JAX package's trainer wraps one optimizer per stage in
``optax.masked``, which passes the raw gradient through as the update of
every parameter outside the stage, so there every parameter moves by
``+grad`` in every stage.

Epochs: ``n_warm_epochs`` warm epochs, then joint ones; at
``push_start_epoch`` and every ``push_every_n`` epochs after it, the push
and ``n_push_iters`` last-layer epochs; a test epoch after every epoch.
On the card each stage's step is a CUDA-graph replay over the device
cache (one graph a stage, the eval graph with the last stage's); the push
runs eager batches.  ``protopnet_2d`` takes host epochs over its images,
as the JAX package's trainer does (``deepards_tpu/train/
protopnet_trainer.py:125-130, 172, 208-211, 441-451``): each batch
gathered, normalized and augmented on the host in the JAX package's order
(zero-padded at the end of an epoch), its norms' rows the images, its
push over the train images in order through ``gather``.  Under bfloat16
compute the train forward casts the params as ``Trainer``'s steps do;
eval and the push run in float32, as the JAX package's do.
"""
import itertools

import numpy as np
import torch

from deepards_tpu_torch.data.pipeline import BatchPipeline
from deepards_tpu_torch.models.layers import bn_row_mask
from deepards_tpu_torch.parallel import mesh
from deepards_tpu_torch.train import losses as loss_lib
from deepards_tpu_torch.train.loader import EpochLoader, PrefetchLoader
from deepards_tpu_torch.train.loop import (
    Trainer,
    _epoch_order,
    _pad_batch,
    sample_shapes,
)
from deepards_tpu_torch.train.steps import (
    StepRunner,
    TrainState,
    make_optimizer,
)

STAGES = ("warm", "joint", "last")
AUX = ("cls_loss", "clst_loss", "sep_loss", "l1_loss")


def ppnet_loss(logits, target, min_distances, class_identity_windows,
               max_dist, clust_lambda=0.8, sep_lambda=0.2, use_l1=False,
               last_layer_kernel=None, weights=None):
    """BCE of the clipped softmax + clust * cluster + sep * separation +
    1e-4 * L1 of the off-class last-layer weights; ``last_layer_kernel``
    is (S*P, classes), the flax layout (reference:
    train_ards_detector.py:1194-1247).  Returns (loss, (cls, cluster,
    separation, l1))."""
    probs = torch.softmax(logits, dim=-1).clamp(1e-7, 1 - 1e-7)
    bce_rows = -(target * torch.log(probs)
                 + (1 - target) * torch.log(1 - probs)).mean(dim=-1)
    ident = class_identity_windows  # (S*P, classes)
    correct = ident.index_select(1, target.argmax(dim=1)).t()  # (B, S*P)
    inverted = max_dist - min_distances
    cluster = max_dist - (inverted * correct).max(dim=1).values
    separation = max_dist - (inverted * (1 - correct)).max(dim=1).values
    if use_l1 and last_layer_kernel is not None:
        l1 = (last_layer_kernel * (1 - ident)).abs().sum()
        axis = mesh.current_sharding()
        if axis is not None and axis.rank:
            l1 = l1 * 0  # the ranks' losses sum to one L1 term
    else:
        l1 = torch.zeros((), dtype=logits.dtype, device=logits.device)
    cls, cluster, separation = (
        loss_lib.weighted_mean(rows, weights)
        for rows in (bce_rows, cluster, separation))
    loss = (cls + clust_lambda * cluster + sep_lambda * separation
            + 1e-4 * l1)
    return loss, (cls, cluster, separation, l1)


def stage_groups(model):
    """Each stage's parameters
    (reference: train_ards_detector.py:1158-1192)."""
    add_on = list(model.add_on_layers.parameters())
    protos = [model.prototype_vectors]
    return {"warm": add_on + protos,
            "joint": list(model.breath_block.parameters()) + add_on + protos,
            "last": [model.last_layer.weight]}


class StagedOptimizers:
    """One optimizer a stage; ``state_dict`` keyed by stage."""

    def __init__(self, optimizers):
        self.stages = optimizers

    def state_dict(self):
        return {k: v.state_dict() for k, v in self.stages.items()}

    def load_state_dict(self, state):
        for k, v in state.items():
            self.stages[k].load_state_dict(v)


def make_ppnet_steps(model, transform, class_identity_windows, max_dist,
                     clust_lambda=0.8, sep_lambda=0.2, use_l1=False,
                     compute_dtype=None, dropout_active=True,
                     bn_mask_rows="windows"):
    """({stage: train_step}, eval_step) over ``(state, data, target,
    mask)`` batches, as ``make_train_step``'s: the row mask scoped for the
    norms (repeated over the S windows, or as it is with ``bn_mask_rows``
    'batch') and weighting the loss; ``transform`` None for images.  A
    stage's train step returns the (5,) loss, cls, cluster, separation and
    l1; the eval step (float32, dropout off, no L1, as the JAX package's)
    the loss and the logits."""
    groups = stage_groups(model)
    ident = class_identity_windows

    def forward(state, data, mask, active, cast):
        if transform is not None:
            data = transform(data)
        rows = mask
        if bn_mask_rows == "windows":
            rows = mask[:, None].expand(-1, data.shape[1]).reshape(-1)
        with bn_row_mask(rows):
            if cast and compute_dtype is not None:
                params = {name: p.to(compute_dtype)
                          for name, p in model.named_parameters()}
                logits, min_d = torch.func.functional_call(
                    model, params,
                    (data.to(compute_dtype), not active, state.generator))
                return logits.float(), min_d.float()
            return model(data, not active, state.generator)

    def train_step_of(stage):
        params = groups[stage]

        def train_step(state, data, target, mask):
            logits, min_d = forward(state, data, mask, dropout_active, True)
            kernel = model.last_layer.weight.t() if use_l1 else None
            loss, aux = ppnet_loss(logits, target, min_d, ident, max_dist,
                                   clust_lambda, sep_lambda, use_l1, kernel,
                                   mask)
            grads = torch.autograd.grad(loss, params)
            for p, g in zip(params, grads):
                p.grad = g
            state.optimizer.step()
            state.step += 1
            return mesh.global_sum(torch.stack(
                [loss.detach()] + [a.detach() for a in aux]))

        return train_step

    @torch.no_grad()
    def eval_step(state, data, target, mask):
        logits, min_d = forward(state, data, mask, False, False)
        loss, _ = ppnet_loss(logits, target, min_d, ident, max_dist,
                             clust_lambda, sep_lambda, weights=mask)
        return mesh.global_sum(loss), logits

    return {s: train_step_of(s) for s in STAGES}, eval_step


class ProtoPNetTrainer(Trainer):
    """Drives PPNet through warm -> joint -> push/last-layer cycles."""

    def new_state(self, fold_num):
        """A fresh model, one optimizer a stage over its group (no
        clamp, as the JAX package's) and the dropout generator."""
        conf = self.conf
        model = self.build_model()
        self.init_model(model, fold_num)
        model.to(self.device)
        optimizers = StagedOptimizers({
            stage: make_optimizer(
                params, optimizer=conf.get("optimizer", "sgd"),
                learning_rate=conf.get("learning_rate", 0.001),
                weight_decay=conf.get("weight_decay", 0.0001))
            for stage, params in stage_groups(model).items()})
        generator = torch.Generator(device=self.device).manual_seed(
            self._fold_seed(fold_num, 1))
        mesh.replicate_tree(model.parameters())
        return TrainState(model, optimizers, generator)

    def make_steps(self, state, dataset, dropout=True):
        conf = self.conf
        model = state.model
        ident = torch.as_tensor(model.class_identity_windows(),
                                device=self.device)
        options = self.step_options(dataset)
        return make_ppnet_steps(
            model, options["transform"], ident,
            model.max_dist, clust_lambda=conf.get("clust_lambda", 0.8),
            sep_lambda=conf.get("sep_lambda", 0.2),
            use_l1=bool(conf.get("use_l1")),
            compute_dtype=self.compute_dtype, dropout_active=dropout,
            bn_mask_rows=options["bn_mask_rows"])

    def make_runners(self, state, dataset, dropout=True, graphed=None):
        """A ``StepRunner`` a stage over the fold's model and generator,
        the eval step with the last stage's; CUDA-graph replays on the
        card unless ``graphed`` says otherwise."""
        train_steps, eval_step = self.make_steps(state, dataset, dropout)
        data_shape, target_width = sample_shapes(dataset)
        shape = (self.batch_rows()[1],) + data_shape
        if graphed is None:
            graphed = self.device.type == "cuda" and not self.axis.sharded
        return {stage: StepRunner(
            TrainState(state.model, state.optimizer.stages[stage],
                       state.generator),
            train_steps[stage], eval_step if stage == "last" else None,
            shape, target_width=target_width, graphed=graphed,
            axis=self.axis)
            for stage in STAGES}

    def run_fold(self, fold_num, train_dataset, test_dataset):
        conf = self.conf
        self.last_train_count = len(train_dataset.current_indices())
        self.last_test_count = len(test_dataset.current_indices())
        self.sample_draws(train_dataset)
        state = self.new_state(fold_num)
        runners = self.make_runners(state, train_dataset)
        epochs = conf.get("epochs", 10)
        n_warm = conf.get("n_warm_epochs", 3)
        push_start = conf.get("push_start_epoch", 6)
        push_every = conf.get("push_every_n", 6)
        n_push_iters = conf.get("n_push_iters", 5)
        self.push_infos = []
        with self.deferred_fetch():
            for epoch_num in range(1, epochs + 1):
                stage = "warm" if epoch_num <= n_warm else "joint"
                self.run_ppnet_epoch(runners[stage], train_dataset, fold_num,
                                     epoch_num)
                if (epoch_num >= push_start
                        and (epoch_num - push_start) % push_every == 0):
                    self.push_prototypes(state.model, train_dataset)
                    for _ in range(n_push_iters):
                        self.run_ppnet_epoch(runners["last"], train_dataset,
                                             fold_num, epoch_num)
                        if conf.get("debug"):
                            break
                self.run_test_epoch(runners["last"], test_dataset, fold_num,
                                    epoch_num)
                if conf.get("save_model_per_epoch") and conf.get("save_model"):
                    self.save_checkpoint(self._total(state, runners),
                                         fold_num, epoch_num)
        state = self._total(state, runners)
        if conf.get("save_model"):
            self.save_checkpoint(state, fold_num, None)
        self.final_state = state
        return state

    @staticmethod
    def _total(state, runners):
        """The fold's state with the step count of every stage's runner."""
        state.step = sum(r.state.step for r in runners.values())
        return state

    def run_ppnet_epoch(self, runner, dataset, fold_num, epoch_num):
        """One epoch of a stage over the device cache (a host epoch for
        images): a permutation from the host generator, as the JAX
        package draws it."""
        if self.spec.two_dim:
            out = self._host_ppnet_steps(runner, dataset)
        else:
            idx = np.asarray(dataset.current_indices())
            ids, masks = _epoch_order(self.host_rng.permutation(idx),
                                      self.batch_rows()[0])
            if self.conf.get("debug"):
                ids, masks = ids[:1], masks[:1]
            out, _ = self._device_steps(runner, dataset, ids, masks, True)
        self._defer(self._record_ppnet_losses, out, fold_num, epoch_num)

    def _host_ppnet_steps(self, runner, dataset):
        """A stage's steps over batches gathered on the host (a thread
        prepares the next while the card runs one; one batch with
        ``debug``): the (steps, 5) losses on the device."""
        batch_size = self.conf.get("batch_size", 16)
        loader = EpochLoader(dataset, batch_size, shuffle=True,
                             rng=self.host_rng)
        steps = 1 if self.conf.get("debug") else len(loader)
        batches = PrefetchLoader(
            itertools.islice(loader, steps),
            map_fn=lambda b: self.device_batch(b, self.batch_rows()[0]))
        return self._host_steps(runner, batches, steps)[0]

    def _record_ppnet_losses(self, out, fold_num, epoch_num):
        for row in out.cpu().numpy():
            for name, value in zip(AUX, row[1:]):
                self.results.update_meter(name, fold_num, float(value))
            self.results.update_meter(
                "loss_epoch_{}".format(epoch_num), fold_num, float(row[0]))
            self.results.update_loss(fold_num, float(row[0]))

    @torch.no_grad()
    def push_prototypes(self, model, dataset):
        """Project each prototype onto the nearest latent patch of its own
        class over ``dataset``'s windows in order, in batches of the
        batch size (dropout off, float32, the pad rows of the last batch
        out of the norms' statistics and masked to inf before the argmin),
        the host keeping a strictly smaller distance across batches, so the
        first batch wins a tie.  Records ``push_info`` (window index, flat
        position in the window's S*L' patches or, for an image, its
        row-major H'*W' positions, distance) per prototype in
        ``self.last_push_info`` (reference: ppnet_push.py's loop)."""
        batch_size = self.conf.get("batch_size", 16)
        p, c = model.num_prototypes, model.proto_channels
        cls_of_proto = torch.as_tensor(model.class_identity().argmax(axis=1),
                                       device=self.device)
        protos = torch.arange(p, device=self.device)
        idx = np.asarray(dataset.current_indices())
        best = np.full(p, np.inf)
        patches = np.zeros((p, c), np.float32)
        push_info = [None] * p
        for step, (data, label, valid) in enumerate(
                self._push_batches(dataset, idx, batch_size)):
            rows = valid.float()
            if not self.spec.two_dim:
                rows = rows.repeat_interleave(data.shape[1])
            with bn_row_mask(rows):
                feats, dists = model.push_forward(data, True)
            b = dists.shape[0]
            flat_d = dists.reshape(b, -1, p)
            allowed = (label[:, None] == cls_of_proto[None, :]) & valid[:,
                                                                        None]
            flat_d = torch.where(allowed[:, None, :], flat_d,
                                 torch.full_like(flat_d, float("inf")))
            batch_best, best_pos = flat_d.min(dim=1)  # (B, P)
            dmin, row = batch_best.min(dim=0)  # (P,)
            pos = best_pos[row, protos]
            patch = feats.reshape(b, -1, feats.shape[-1])[row, pos]
            dmin, row, pos, patch = (t.cpu().numpy()
                                     for t in (dmin, row, pos, patch))
            better = dmin < best
            best = np.where(better, dmin, best)
            for j in np.nonzero(better)[0]:
                patches[j] = patch[j]
                push_info[j] = {
                    "window_index": int(idx[step * batch_size + row[j]]),
                    "flat_pos": int(pos[j]),
                    "distance": float(dmin[j]),
                }
        model.prototype_vectors.copy_(torch.from_numpy(
            patches.reshape(model.prototype_shape)))
        self.last_push_info = push_info
        self.push_infos.append(push_info)
        return push_info

    def _push_batches(self, dataset, idx, batch_size):
        """(data, labels, valid rows) of the windows ``idx`` in order, in
        batches of ``batch_size`` on the device: gathered on the card from
        the device cache and normalized there (the last batch filled by
        tiling), or for images gathered on the host (the last batch
        zero-padded)."""
        if self.spec.two_dim:
            for start in range(0, len(idx), batch_size):
                batch = dataset.gather(idx[start:start + batch_size])
                batch, mask = _pad_batch(
                    {"data": batch["data"], "target": batch["target"]},
                    batch_size)
                target = torch.from_numpy(batch["target"]).to(self.device)
                yield (torch.from_numpy(batch["data"]).to(self.device),
                       target.argmax(dim=1),
                       torch.from_numpy(mask > 0).to(self.device))
            return
        pipeline = BatchPipeline(dataset, self.device)
        dev = self._get_device_cache(dataset)
        ids, masks = _epoch_order(idx, batch_size)
        for ids_s, mask_s in zip(ids, masks):
            rows_d = torch.as_tensor(ids_s, device=self.device)
            yield (pipeline(dev["data"].index_select(0, rows_d)),
                   dev["target"].index_select(0, rows_d).argmax(dim=1),
                   torch.as_tensor(mask_s > 0, device=self.device))
