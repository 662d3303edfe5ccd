"""GradCAM for the 1D CNN classifiers.

Counterpart of ``deepards_tpu/explain/gradcam.py`` (reference:
deepards/gradcam.py:28-205): the backbone's feature map before its final
ReLU (``breath_block.features``, dropout off), the gradient of the
one-hot class score with respect to that map, the gradient's mean over
positions as channel weights, the weighted sum over channels, and three
normalizations (``MaxMinNormCam``, ``FracTotalNormCam``,
``UnNormalizedCam``).

A batch of sequences goes through the backbone as one (B*S)-row call with
``groups=B``, so each sequence's S windows keep normalization statistics
of their own, as the JAX package's vmap over sequences gives them.  One
backward pass of the summed class scores then gives every sequence's
gradient: a sequence's score reads only its own rows of the feature map.
The head must be one Linear over the flattened pooled window features
(the cnn_linear family); a head of more Linear layers is refused.
"""
import numpy as np
import torch
import torch.nn.functional as F

from deepards_tpu_torch.models.layers import linear_resize_weights


class GradCam:
    """Cams of ``model``, a cnn_linear-family network (``breath_block``
    with ``features``, one Linear ``head``), on its device."""

    def __init__(self, model, record_grads=False):
        self.model = model
        self.head = self._head_linear(model)
        self.device = next(model.parameters()).device
        # per-call gradients and outputs, for gradient-norm histograms
        self.record_grads = record_grads
        self.grads = []
        self.preds = []

    @staticmethod
    def _head_linear(model):
        layers = getattr(model, "layers", None)
        if layers is not None and len(layers) > 1:
            raise NotImplementedError(
                "GradCam supports single-Linear heads (cnn_linear family); "
                "{} has {} Linear layers".format(type(model).__name__,
                                                 len(layers)))
        head = getattr(model, "head", None)
        if head is None:
            raise ValueError("could not locate the head Linear")
        return head

    def _fmaps_and_grads(self, xs, targets=None):
        """xs (B, S, C, L) -> (feature maps (B, S, C', L'), their
        gradients, logits (B, 2)), the gradient of each sequence's score
        of its target class (its argmax where ``targets`` is None)."""
        xs = torch.as_tensor(np.asarray(xs, np.float32), device=self.device)
        b, s, c, length = xs.shape
        with torch.no_grad():
            fmap = self.model.breath_block.features(
                xs.reshape(b * s, c, length), True, None, b)
        fmap.requires_grad_(True)
        with torch.enable_grad():
            pooled = F.relu(fmap).mean(dim=2)  # (B*S, C')
            out = self.head(pooled.reshape(b, -1))  # (B, 2)
            if targets is None:
                targets = out.argmax(dim=1)
            targets = torch.as_tensor(targets, device=self.device).long()
            one_hot = F.one_hot(targets, out.shape[-1]).to(out.dtype)
            (grad,) = torch.autograd.grad((one_hot * out).sum(), fmap)
        shape = (b, s) + fmap.shape[1:]
        return fmap.detach().reshape(shape), grad.reshape(shape), \
            out.detach()

    @staticmethod
    def _cams(fmaps, grads):
        """(..., C', L') maps and gradients -> (..., L') cams."""
        weights = grads.mean(dim=-1, keepdim=True)
        return (fmaps * weights).sum(dim=-2)

    def read_cams_batch(self, xs, targets):
        """Raw per-read cams of a batch: (B, S, L') float32 and (B, 2)
        outputs, as numpy."""
        fmaps, grads, out = self._fmaps_and_grads(xs, targets)
        return self._cams(fmaps, grads).cpu().numpy(), out.cpu().numpy()

    def cams_batch(self, xs, targets):
        """Raw whole-sequence cams of a batch, as ``generate_cam`` gives
        them a sequence at a time: each sequence's gradient averaged over
        its S windows and positions as channel weights, over its feature
        map averaged over its windows.  (B, L') float32 and (B, 2) outputs,
        as numpy."""
        fmaps, grads, out = self._fmaps_and_grads(xs, targets)
        weights = grads.mean(dim=(1, 3))  # (B, C')
        cams = (weights[:, :, None] * fmaps.mean(dim=1)).sum(dim=1)
        return cams.cpu().numpy(), out.cpu().numpy()

    def _grad_and_output(self, x, target):
        """x: one (S, C, L) sequence -> (conv (S, C', L'), grad, (1, 2)
        output) as numpy; ``target`` None takes the predicted class."""
        fmaps, grads, out = self._fmaps_and_grads(
            np.asarray(x)[None], None if target is None else [int(target)])
        conv, grad = fmaps[0].cpu().numpy(), grads[0].cpu().numpy()
        out = out.cpu().numpy()
        if self.record_grads:
            self.grads.append(grad)
            self.preds.append(out)
        return conv, grad, out


class MaxMinNormCam(GradCam):
    """(reference: gradcam.py:110-162)"""

    def generate_read_cams_batch(self, xs, targets):
        """(B, S, L') uint8 per-read cams of a batch of sequences (B, S, C,
        L) for ``targets`` (B,), and the (B, 2) outputs."""
        cams, outs = self.read_cams_batch(xs, targets)
        normed = np.stack([np.stack([self.normalize(c) for c in seq])
                           for seq in cams])
        return normed, outs

    def generate_read_cam(self, x, target):
        conv, grad, out = self._grad_and_output(x, target)
        weights = grad.mean(axis=2)  # (S, C')
        cam = (weights[:, :, None] * conv).sum(axis=1)  # (S, L')
        return np.stack([self.normalize(c) for c in cam]), out

    def generate_cam(self, x, target=None):
        conv, grad, out = self._grad_and_output(x, target)
        weights = grad.mean(axis=(0, 2))  # (C',)
        cam = (weights[:, None] * conv.mean(axis=0)).sum(axis=0)
        return self.normalize(cam), out

    def generate_cams_batch(self, xs, targets):
        """(B, L') uint8 whole-sequence cams and (B, 2) outputs of a batch
        (``generate_cam`` of each sequence)."""
        cams, outs = self.cams_batch(xs, targets)
        return np.stack([self.normalize(c) for c in cams]), outs

    @staticmethod
    def normalize(cam):
        cam = np.maximum(cam, 0)
        span = cam.max() - cam.min()
        cam = (cam - cam.min()) / (span if span else 1.0)
        return np.uint8(cam * 255)


class FracTotalNormCam(GradCam):
    """Target-vs-other-class cam ratio (reference: gradcam.py:165-192)."""

    def generate_read_cam(self, x, target):
        conv, grad_t, out = self._grad_and_output(x, target)
        _, grad_o, _ = self._grad_and_output(x, (target + 1) % 2)
        cam_t = (grad_t.mean(axis=2)[:, :, None] * conv).sum(axis=1)
        cam_o = (grad_o.mean(axis=2)[:, :, None] * conv).sum(axis=1)
        return np.stack([self.normalize(ct, co)
                         for ct, co in zip(cam_t, cam_o)]), out

    @staticmethod
    def normalize(cam_target, cam_other):
        cam_target = np.maximum(cam_target, 0)
        cam_other = np.maximum(cam_other, 0)
        denom = cam_target + cam_other
        denom = np.where(denom == 0, 1.0, denom)
        return np.uint8(cam_target / denom * 255)


class UnNormalizedCam(GradCam):
    """(reference: gradcam.py:195-205)"""

    def generate_cam(self, x, target=None):
        conv, grad, out = self._grad_and_output(x, target)
        weights = grad.mean(axis=(0, 2))
        cam = (weights[:, None] * conv.mean(axis=0)).sum(axis=0)
        return np.maximum(0, cam), out

    def generate_read_cam(self, x, target):
        conv, grad, out = self._grad_and_output(x, target)
        cam = (grad.mean(axis=2)[:, :, None] * conv).sum(axis=1)
        return np.maximum(0, cam), out

    def generate_cams_batch(self, xs, targets):
        """(B, L') unnormalized whole-sequence cams and (B, 2) outputs."""
        cams, outs = self.cams_batch(xs, targets)
        return np.maximum(0, cams), outs

    def generate_read_cams_batch(self, xs, targets):
        """(B, S, L') unnormalized cams and (B, 2) outputs."""
        cams, outs = self.read_cams_batch(xs, targets)
        return np.maximum(0, cams), outs


def upsample_cam(cam, target_len=224):
    """A (L',) cam or (S, L') cams resized linearly to ``target_len`` on
    the last axis, as the JAX package's ``jax.image.resize(...,
    "linear")`` does it (its edge and antialias rules, not
    ``F.interpolate``'s)."""
    cam = np.asarray(cam, np.float32)
    weights = linear_resize_weights(cam.shape[-1], target_len).astype(
        np.float32)
    return cam @ weights
