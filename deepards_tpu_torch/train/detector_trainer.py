"""Training loop of the row-band detector.

Counterpart of ``deepards_tpu/train/detector_trainer.py`` (reference: the
retinanet_2d path through ImgARDSDataset's bbox mode,
deepards/train_ards_detector.py:118-121 and dataset.py:1776-1825).  The
targets are the band boxes rasterized to per-row one-hot labels, the loss
is sigmoid focal loss (``fl_gamma``, ``fl_alpha``).  Each epoch trains
over the train images in a permutation of the host generator, in whole
batches (a split smaller than one batch is one padded batch), then
evaluates the train split (``band_iou``, a sanity curve) and the test
split (``band_iou_test`` and ``test_loss``): each image's mean best IoU of
its true bands against the bands its row logits give.  The last eval
batch is zero-padded, its pad images weighted out of the loss, the IoU
and the norms' statistics.

Batches are gathered on the host (``ImgARDSDataset.gather``, with the
train split's transforms, in the JAX package's order); a thread prepares
the next batch while the card runs one, and on the card every step is a
CUDA-graph replay (``StepRunner``).
"""
import itertools

import numpy as np
import torch

from deepards_tpu_torch.models.detection2d import (
    detection_loss,
    extract_bands,
    row_labels_from_boxes,
)
from deepards_tpu_torch.models.layers import bn_row_mask
from deepards_tpu_torch.train.loader import PrefetchLoader
from deepards_tpu_torch.train.loop import Trainer

ROWS = 224


def band_iou(pred_bands, true_boxes, true_labels):
    """Mean best IoU over the true bands (rows only: bands are full
    width); 0 with no predicted band."""
    if not pred_bands:
        return 0.0
    ious = []
    for (_, y1, _, y2), lab in zip(true_boxes, true_labels):
        best = 0.0
        for (_, py1, _, py2), plab, _ in pred_bands:
            if plab != lab:
                continue
            inter = max(0.0, min(y2, py2) - max(y1, py1))
            union = (y2 - y1) + (py2 - py1) - inter
            if union > 0:
                best = max(best, inter / union)
        ious.append(best)
    return float(np.mean(ious)) if ious else 0.0


def make_detector_steps(gamma=2.0, alpha=0.25, compute_dtype=None):
    """(train_step, eval_step) over ``(state, data (B, C, H, W), target
    (B, rows, 2), mask (B,))``: the mask scoped for the norms and weighting
    the focal loss; params and data cast to ``compute_dtype`` for the
    forward (in eval too, as the JAX package's), the logits back to
    float32.  The train step returns the loss, the eval step the loss and
    the (B, rows, 2) logits."""

    def forward(state, data, mask, active):
        model = state.model
        with bn_row_mask(mask):
            if compute_dtype is None:
                return model(data, not active, state.generator)
            params = {name: p.to(compute_dtype)
                      for name, p in model.named_parameters()}
            return torch.func.functional_call(
                model, params, (data.to(compute_dtype), not active,
                                state.generator)).float()

    def train_step(state, data, target, mask):
        logits = forward(state, data, mask, True)
        loss = detection_loss(logits, target, gamma, alpha, weights=mask)
        state.optimizer.zero_grad()
        loss.backward()
        state.optimizer.step()
        state.step += 1
        return loss.detach()

    @torch.no_grad()
    def eval_step(state, data, target, mask):
        logits = forward(state, data, mask, False)
        return detection_loss(logits, target, gamma, alpha,
                              weights=mask), logits

    return train_step, eval_step


class DetectorTrainer(Trainer):
    target_shape = (ROWS, 2)  # per-row one-hot labels
    shards_batches = False  # its batches run whole on every rank

    def run_fold(self, fold_num, train_dataset, test_dataset):
        conf = self.conf
        self.sample_draws(train_dataset)
        state = self.fold_state(fold_num)
        train_step, eval_step = make_detector_steps(
            gamma=conf.get("fl_gamma", 2.0), alpha=conf.get("fl_alpha", 0.25),
            compute_dtype=self.compute_dtype)
        runner = self.make_runner(state, train_dataset, train_step,
                                  eval_step)
        epochs = conf.get("epochs", 10)
        resume = self.resume_meta
        if not (resume and resume["fold"] == fold_num):
            resume = None
        with self.deferred_fetch():
            for epoch_num in range(resume["epoch"] if resume else 1,
                                   epochs + 1):
                if not conf.get("no_train"):
                    losses = self.run_detector_train_epoch(runner,
                                                           train_dataset)
                    self._defer(self._record_step_losses, losses, fold_num)
                if not conf.get("no_test_after_epochs") or epoch_num == epochs:
                    # the train split's IoU is a sanity curve; the held-out
                    # metric is the test split's, on its own splices
                    for dataset, meter in ((train_dataset, "band_iou"),
                                           (test_dataset, "band_iou_test")):
                        self.run_detector_eval(runner, dataset, fold_num,
                                               epoch_num, meter)
                if conf.get("save_model_per_epoch") and conf.get("save_model"):
                    self.save_checkpoint(state, fold_num, epoch_num)
        if conf.get("save_model"):
            self.save_checkpoint(state, fold_num, None)
        if resume:
            self.resume_meta = None
        self.final_state = state
        return state

    def _batches(self, dataset, selections):
        """Device batches {data, target (row labels), mask} of the image
        selections, each gathered and zero-padded to the batch size by a
        thread ahead of the card."""
        batch_size = self.conf.get("batch_size", 16)

        def prepare(sel):
            batch = dataset.gather(sel)
            rows = row_labels_from_boxes(batch["boxes"], batch["labels"],
                                         ROWS)
            return self.device_batch({"data": batch["data"],
                                      "target": rows}, batch_size)

        return PrefetchLoader(selections, map_fn=prepare)

    def run_detector_train_epoch(self, runner, dataset):
        """Whole batches of a permutation (one with ``debug``): the (steps,)
        losses on the device."""
        batch_size = self.conf.get("batch_size", 16)
        idx = self.host_rng.permutation(dataset.current_indices())
        steps = 1 if self.conf.get("debug") else max(
            len(idx) // batch_size, 1)
        selections = [idx[s * batch_size:(s + 1) * batch_size]
                      for s in range(steps)]
        selections = list(itertools.takewhile(len, selections))
        return self._host_steps(runner, self._batches(dataset, selections),
                                len(selections))[0]

    def run_detector_eval(self, runner, dataset, fold_num, epoch_num,
                          meter):
        """The whole split in order, in fixed-size batches."""
        batch_size = self.conf.get("batch_size", 16)
        idx = dataset.current_indices()
        selections = [idx[s:s + batch_size]
                      for s in range(0, len(idx), batch_size)]
        losses, outs = self._host_steps(
            runner, self._batches(dataset, selections), len(selections),
            train=False)
        truth = [(len(sel), dataset.bbox_targets["boxes"][sel],
                  dataset.bbox_targets["labels"][sel]) for sel in selections]
        self._defer(self._record_detector_eval, losses, outs, truth,
                    fold_num, epoch_num, meter)

    def _record_step_losses(self, losses, fold_num):
        if losses is None:
            return
        for loss in losses.cpu().numpy():
            self.results.update_loss(fold_num, float(loss))

    def _record_detector_eval(self, losses, outs, truth, fold_num,
                              epoch_num, meter):
        """The split's mean band IoU (threshold 0: every run of rows is a
        band) into ``meter``; for the test split the loss, a mean over the
        real images, into ``test_loss``."""
        if losses is None:  # an empty split
            return
        losses = losses.cpu().numpy()
        outs = outs.cpu().numpy()
        ious = []
        for logits, (n_real, boxes, labels) in zip(outs, truth):
            bands = extract_bands(logits[:n_real], threshold=0.0)
            ious.extend(band_iou(bands[i], boxes[i], labels[i])
                        for i in range(n_real))
        n_reals = [n for n, _, _ in truth]
        mean_loss = (sum(float(loss) * n for loss, n in zip(losses, n_reals))
                     / max(sum(n_reals), 1))
        if meter == "band_iou_test":
            self.results.update_meter("test_loss", fold_num, mean_loss)
        self.results.update_meter(meter, fold_num, float(np.mean(ious)))
        self.results.update_epoch_meter(meter, epoch_num,
                                        float(np.mean(ious)))

    def perform_post_modeling_actions(self):
        self.results.save_all()
