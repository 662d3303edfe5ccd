"""Siamese pretraining: each anchor window against its positive (the
patient's next window) and a negative (another patient's window).

Counterpart of ``deepards_tpu/train/siamese_trainer.py`` (reference:
deepards/train_ards_detector.py:558-659, ``SiameseMixin``).  The loss is
BCE(out_pos, [0, 1]) + BCE(out_neg, [1, 0]), each the mean over its (B,
2) logits.  The JAX trainer makes its two calls with one dropout key and
evaluates with dropout on; so does this one: the model compares the
anchor with both in one call (``forward(..., negative=...)``, see
``models/siamese.py``), and eval draws its masks from the fold's
generator as training does.

The train and test splits are ``SiameseWindowDataset``s over the ``main``
holdout, with no folds; a fold draws two triplets first (the JAX trainer
draws them to initialize its model), then each epoch permutes the
anchors with the host generator and draws the triplets of its full
batches (a partial batch is dropped), and the test epoch the triplets of
its full batches in order.  Each step gathers anchor, positive and
negative by index from the cache on the device into the fold's
``StepRunner``, whose train and eval steps are CUDA-graph replays on the
card.  Records: the train losses (``loss``), and by fold and by epoch the
test losses (``test_loss``) and the accuracy of the pairs' argmax, a
positive pair's class 1 and a negative's 0 (``accuracy``).
"""
import numpy as np
import torch

from deepards_tpu_torch.data.pipeline import BatchPipeline
from deepards_tpu_torch.data.siamese_dataset import SiameseWindowDataset
from deepards_tpu_torch.train import losses as loss_lib
from deepards_tpu_torch.train.loop import Trainer, _store
from deepards_tpu_torch.train.steps import StepRunner

# options the siamese trainer refuses: its datasets have no folds (the
# JAX trainer fails on them with an AttributeError)
REFUSED_OPTIONS = ("kfolds", "bootstrap")


def make_siamese_steps(transform=None, compute_dtype=None,
                       dropout_active=True):
    """(train_step, eval_step), each called as ``(state, data, target,
    mask, positive, negative)`` with raw (B, S, C, L) anchors, positives
    and negatives on the model's device (``target`` and ``mask`` unused:
    every batch is full).  The train step returns the loss, the eval step
    the loss and the (2, B, 2) logits of the positive and the negative
    pairs.  Both run with dropout as ``dropout_active`` says (the JAX
    trainer's eval too) and read nothing back to the host, so both can be
    captured in a CUDA graph."""
    def loss_wrap(state, data, positive, negative):
        if transform is not None:
            data, positive, negative = (
                transform(t) for t in (data, positive, negative))
        model = state.model
        args = (not dropout_active, state.generator)
        if compute_dtype is not None:
            params = {name: p.to(compute_dtype)
                      for name, p in model.named_parameters()}
            out = torch.func.functional_call(
                model, params,
                (data.to(compute_dtype), positive.to(compute_dtype)) + args,
                {"negative": negative.to(compute_dtype)})
            out = out.float()
        else:
            out = model(data, positive, *args, negative=negative)
        targets = torch.eye(2, dtype=out.dtype, device=out.device)
        t_pos = targets[1].expand_as(out[0])
        t_neg = targets[0].expand_as(out[1])
        loss = (loss_lib.bce_with_logits(out[0], t_pos)
                + loss_lib.bce_with_logits(out[1], t_neg))
        return loss, out

    def train_step(state, data, target, mask, positive, negative):
        loss, _ = loss_wrap(state, data, positive, negative)
        state.optimizer.zero_grad()
        loss.backward()
        state.optimizer.step()
        state.step += 1
        return loss.detach()

    @torch.no_grad()
    def eval_step(state, data, target, mask, positive, negative):
        return loss_wrap(state, data, positive, negative)

    return train_step, eval_step


class SiameseTrainer(Trainer):
    shards_batches = False  # its triplet batches run whole on every rank

    def __init__(self, conf, device=None, verbose=True):
        refused = [k for k in REFUSED_OPTIONS if conf.get(k)]
        if refused:
            raise ValueError(
                "{}: {} trains on its own triplet datasets, which have no "
                "folds (the reference's SiameseMixin)".format(
                    ", ".join(refused), conf.network))
        super().__init__(conf, device=device, verbose=verbose)

    def get_base_datasets(self):
        conf = self.conf

        def split(train, pickle_in, pickle_out, seed):
            if conf.get(pickle_in):
                return SiameseWindowDataset.from_pickle(conf.get(pickle_in))
            return SiameseWindowDataset(
                conf.data_path, conf.experiment_num, conf.n_sub_batches,
                dataset_type=conf.dataset_type, cohort_file=conf.cohort_file,
                train=train, to_pickle=conf.get(pickle_out), seed=seed)

        train = split(True, "train_from_pickle", "train_to_pickle", self.seed)
        test = split(False, "test_from_pickle", "test_to_pickle",
                     self.seed + 1)
        self.n_sub_batches = train.n_sub_batches
        self.in_channels = train.base.cache.data.shape[2]
        test.scaling_factors = train.scaling_factors
        return train, test

    def siamese_runner(self, state, dataset):
        """The fold's ``StepRunner`` of ``make_siamese_steps`` with the
        positive and negative buffers, graphed on the card; the transforms
        are the train split's."""
        train_step, eval_step = make_siamese_steps(
            BatchPipeline(dataset.base, self.device), self.compute_dtype)
        shape = (self.conf.get("batch_size", 16),) + \
            dataset.base.cache.data.shape[1:]
        extra = {key: torch.zeros(shape, device=self.device)
                 for key in ("positive", "negative")}
        return StepRunner(state, train_step, eval_step, shape,
                          graphed=self.device.type == "cuda",
                          extra_inputs=extra)

    def run_fold(self, fold_num, train_dataset, test_dataset):
        conf = self.conf
        batch_size = conf.get("batch_size", 16)
        self.last_train_count = len(train_dataset)
        self.last_test_count = len(test_dataset)
        # the JAX trainer's init draws
        train_dataset.sample_triplet_indices(np.arange(2))
        state = self.fold_state(fold_num)
        runner = self.siamese_runner(state, train_dataset)
        with self.deferred_fetch():
            for epoch_num in range(1, conf.get("epochs", 10) + 1):
                order = self.host_rng.permutation(len(train_dataset))
                n_batches = len(order) // batch_size
                if conf.get("debug"):
                    n_batches = min(n_batches, 1)
                triplets = train_dataset.sample_triplet_indices(
                    order[:n_batches * batch_size])
                losses, _ = self.triplet_steps(runner, train_dataset,
                                               triplets, train=True)
                self._defer(self._record_losses, losses, fold_num)
                self.siamese_test_epoch(runner, test_dataset, fold_num,
                                        epoch_num)
        if conf.get("save_model"):
            self.save_checkpoint(state, fold_num, None)
        self.final_state = state
        return state

    def triplet_steps(self, runner, dataset, triplets, train):
        """One step a full batch of ``triplets`` (anchor, positive,
        negative absolute indices), each gathered into the runner's
        buffers from the device cache.  Returns the (steps,) losses and,
        for eval, the (steps, 2, B, 2) logits, on the device."""
        batch_size = runner.inputs["data"].shape[0]
        steps = len(triplets[0]) // batch_size
        table = self._get_device_cache(dataset.base)["data"]
        ids = torch.from_numpy(np.stack(triplets).reshape(
            3, steps, batch_size)).to(self.device)
        losses = outs = None
        for i in range(steps):
            for row, key in enumerate(("data", "positive", "negative")):
                torch.index_select(table, 0, ids[row, i],
                                   out=runner.inputs[key])
            if train:
                loss = runner.train()
            else:
                loss, out = runner.eval()
                outs = _store(outs, i, out, steps)
            losses = _store(losses, i, loss, steps)
        if losses is None:
            losses = torch.empty(0, device=self.device)
        return losses, outs

    def siamese_test_epoch(self, runner, dataset, fold_num, epoch_num):
        batch_size = runner.inputs["data"].shape[0]
        n_full = len(dataset) // batch_size
        triplets = dataset.sample_triplet_indices(
            np.arange(n_full * batch_size))
        losses, outs = self.triplet_steps(runner, dataset, triplets,
                                          train=False)
        self._defer(self._record_siamese_eval, losses, outs, fold_num,
                    epoch_num)

    def _record_losses(self, losses, fold_num):
        for loss in losses.cpu().numpy():
            self.results.update_loss(fold_num, float(loss))

    def _record_siamese_eval(self, losses, outs, fold_num, epoch_num):
        for loss in losses.cpu().numpy():
            self.results.update_meter("test_loss", fold_num, float(loss))
            self.results.update_epoch_meter("test_loss", epoch_num,
                                            float(loss))
        if outs is None:
            return
        outs = outs.cpu().numpy()  # (steps, 2, B, 2)
        preds = outs.argmax(axis=-1)
        accuracy = float(np.mean(preds == np.array([1, 0])[None, :, None]))
        self.results.update_meter("accuracy", fold_num, accuracy)
        self.results.update_epoch_meter("accuracy", epoch_num, accuracy)

