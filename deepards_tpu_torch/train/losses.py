"""Loss registry: BCE-with-logits, vacillating, confidence-penalty, MSE,
MAE and focal.

Counterpart of ``deepards_tpu/train/losses.py``.  Each loss is computed
per element, averaged over everything but the batch axis, then averaged
over the rows with optional per-row ``weights`` (B,), divided by
``max(sum(weights), 1)``, so pad rows of a fixed-size batch count zero.
With ``weights=None`` it is the plain mean.  Inside ``mesh.sharded_rows``
the divisor is the count of every rank's rows.
"""
import torch
import torch.nn.functional as F

from deepards_tpu_torch.parallel import mesh


def weighted_mean(per_row, weights):
    """The mean of ``per_row`` weighted by ``weights``.  Inside
    ``mesh.sharded_rows`` the rows are one rank's shard: its weighted sum
    over the count of every rank's rows, so the ranks' losses sum to the
    whole batch's."""
    if mesh.current_sharding() is not None:
        if weights is None:
            weights = torch.ones_like(per_row)
        count = mesh.global_sum(weights.sum())
        return (per_row * weights).sum() / torch.clamp(count, min=1.0)
    if weights is None:
        return per_row.mean()
    return (per_row * weights).sum() / torch.clamp(weights.sum(), min=1.0)


def _row_reduce(elementwise):
    """Mean over everything but the leading batch axis."""
    dims = tuple(range(1, elementwise.ndim))
    return elementwise.mean(dim=dims) if dims else elementwise


def bce_with_logits(logits, target, weights=None):
    """Elementwise sigmoid BCE (torch.nn.BCEWithLogitsLoss's function)."""
    elementwise = F.binary_cross_entropy_with_logits(
        logits, target, reduction="none")
    return weighted_mean(_row_reduce(elementwise), weights)


def mse(pred, target, weights=None):
    return weighted_mean(_row_reduce((pred - target) ** 2), weights)


def mae(pred, target, weights=None):
    return weighted_mean(_row_reduce(torch.abs(pred - target)), weights)


def vacillating_loss(logits, target, alpha, weights=None):
    """BCE + a piecewise -log penalty pushing the per-window mean softmax
    away from 0.5 (reference: deepards/loss.py:7-23): the right-hand
    branch where the left-hand value is invalid, capped at alpha."""
    bce = bce_with_logits(logits, target, weights)
    p = torch.softmax(logits, dim=-1)
    frac = p.sum(dim=1) / p.shape[1]
    # a fill, not a copy from the host: capturable in a CUDA graph
    alpha = torch.full((), alpha, dtype=logits.dtype, device=logits.device)
    lh = -torch.log(2 * (torch.exp(-alpha) - 1) * frac + 1)
    rh = -torch.log(2 * torch.exp(-alpha) * (1 - frac) + 2 * frac - 1)
    lh = torch.where(torch.isnan(lh) | (lh > alpha), rh, lh)
    lh = torch.minimum(lh, alpha)
    return bce + weighted_mean(_row_reduce(lh), weights)


def confidence_penalty_loss(logits, target, beta, weights=None):
    """BCE - beta * entropy (reference: deepards/loss.py:26-35)."""
    bce = bce_with_logits(logits, target, weights)
    logp = torch.log_softmax(logits, dim=-1)
    p = torch.softmax(logits, dim=-1)
    confidence = -weighted_mean(_row_reduce(beta * p * logp), weights)
    return bce - confidence


def focal_loss(logits, target, alpha=0.25, gamma=2.0, weights=None):
    """torchvision.ops.sigmoid_focal_loss with mean reduction."""
    p = torch.sigmoid(logits)
    ce = F.binary_cross_entropy_with_logits(logits, target, reduction="none")
    p_t = p * target + (1 - p) * (1 - target)
    loss = ce * ((1 - p_t) ** gamma)
    if alpha >= 0:
        alpha_t = alpha * target + (1 - alpha) * (1 - target)
        loss = alpha_t * loss
    return weighted_mean(_row_reduce(loss), weights)


def get_classification_loss(loss_func, valpha=float("inf"), conf_beta=1.0):
    """The classification criterion a config names."""
    if loss_func == "vacillating":
        return lambda logits, target, weights=None: vacillating_loss(
            logits, target, valpha, weights
        )
    if loss_func == "confidence":
        return lambda logits, target, weights=None: confidence_penalty_loss(
            logits, target, conf_beta, weights
        )
    if loss_func == "bce":
        return bce_with_logits
    raise ValueError("unknown loss_func: {}".format(loss_func))
