"""Row-band detection over breath images.

Counterpart of ``deepards_tpu/models/detection2d.py``.  The reference's
boxes are full-width horizontal row bands ([0, y1, 224, y2]) marking
foreign-patho splices (reference: deepards/dataset.py:1776-1825), so the
detector predicts a class distribution per image row: the backbone's map
averaged over the width, a Dense of 128 and ReLU, a linear upsample of the
rows to the image's height (``jax.image.resize``'s weights, as a matmul), a
Dense to the classes; sigmoid focal loss in
training (RetinaNet's classification objective), and band boxes recovered
by grouping rows of one class (``extract_bands``).  The three registered
detectors (retinanet_2d, retinanet_2x1d, faster_rcnn_2d) are this one
module over their backbones, as in the JAX package.
"""
import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from deepards_tpu_torch.models.layers import (
    dense_init,
    linear_resize_weights,
    promoted_linear,
)
from deepards_tpu_torch.train.losses import focal_loss


class RowBandDetector(nn.Module):
    """Backbone features -> per-row logits (N, rows, num_classes)."""

    def __init__(self, breath_block, num_classes=2, rows=224, hidden=128):
        super().__init__()
        self.breath_block = breath_block
        self.rows = rows
        # (rows / 32, rows) weights of jax.image.resize "linear": the
        # densenets halve the rows 5 times
        self.register_buffer("resize", torch.from_numpy(
            linear_resize_weights(rows // 32, rows)).float(),
            persistent=False)
        self.layers = nn.ModuleList([
            nn.Linear(breath_block.n_out_filters, hidden),
            nn.Linear(hidden, num_classes)])

    def reset_parameters(self, generator=None):
        self.breath_block.reset_parameters(generator)
        for layer in self.layers:
            dense_init(layer, generator)
        return self

    def forward(self, x, deterministic=False, generator=None, metadata=None):
        fmap = self.breath_block.forward_no_pool(x, deterministic, generator)
        h = fmap.mean(dim=3)  # (N, C, H'): the width pooled
        h = F.relu(promoted_linear(h.transpose(1, 2), self.layers[0]))
        # the rows upsampled to the image's height as a matmul by the
        # resize weights: deterministic, where F.interpolate's backward
        # adds with atomics
        h = torch.matmul(h.transpose(1, 2), self.resize.to(h.dtype))
        return promoted_linear(h.transpose(1, 2), self.layers[1])


def row_labels_from_boxes(boxes, labels, rows=224):
    """Band boxes ([x1, y1, x2, y2], label) rasterized to per-row one-hot
    (N, rows, 2)."""
    boxes = np.asarray(boxes)
    labels = np.asarray(labels)
    out = np.zeros((boxes.shape[0], rows, 2), np.float32)
    for i in range(boxes.shape[0]):
        for (_, y1, _, y2), lab in zip(boxes[i], labels[i]):
            out[i, int(y1):int(y2), int(lab)] = 1.0
    return out


def detection_loss(row_logits, row_targets, gamma=2.0, alpha=0.25,
                   weights=None):
    """Sigmoid focal loss over the rows; ``weights`` (per image) keeps the
    pad images of a fixed-size batch out of the mean."""
    return focal_loss(row_logits, row_targets, alpha=alpha, gamma=gamma,
                      weights=weights)


def extract_bands(row_logits, threshold=0.5):
    """Runs of rows of one argmax class, as band boxes: per image a list
    of (box [x1, y1, x2, y2], label, mean confidence), the runs whose
    confidence reaches ``threshold``."""
    probs = torch.sigmoid(torch.as_tensor(
        np.asarray(row_logits, np.float32))).numpy()
    out = []
    for img_probs in probs:
        cls = img_probs.argmax(axis=1)
        conf = img_probs.max(axis=1)
        bands = []
        start = 0
        rows = len(cls)
        for r in range(1, rows + 1):
            if r == rows or cls[r] != cls[start]:
                score = float(conf[start:r].mean())
                if score >= threshold:
                    bands.append(([0.0, float(start), 224.0, float(r)],
                                  int(cls[start]), score))
                start = r
        out.append(bands)
    return out
