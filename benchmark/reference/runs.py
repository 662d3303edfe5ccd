"""The reference's runs that a check compares: the first train steps of a
fold from given weights, and a test epoch's logits.

Each run normalizes the raw windows by the fold's (mean, std), draws its
dropout masks from a generator seeded as the run's is, step after step
and layer after layer, and computes in float32 with TF32 off.  A nested
patient's backbone runs in blocks of windows: the window medians first
without autograd, then the LSTM's gradient with respect to them, then
each block again with autograd, fed that gradient, so the memory holds
one block's activations.
"""
import contextlib

import torch

from benchmark.reference import model


@contextlib.contextmanager
def full_float32():
    """TF32 off for matmuls and cuDNN inside the scope."""
    saved = (torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = saved


def _normalize(raw, mu, std):
    mu = torch.as_tensor(mu, dtype=torch.float32, device=raw.device)
    std = torch.as_tensor(std, dtype=torch.float32, device=raw.device)
    return (raw - mu.reshape(1, 1, -1, 1)) / std.reshape(1, 1, -1, 1)


def _backbone_names(params):
    return [k for k in params if k.startswith("breath_block.")]


def cnn_linear_loss_grads(params, x, target, weights, drop, quant=None):
    """(loss, {name: gradient}) of one cnn_linear step over normalized
    windows ``x`` (B, S, C, L)."""
    leaves = {k: v.detach().requires_grad_() for k, v in params.items()}
    logits = model.cnn_linear_logits(leaves, x, weights, drop, quant)
    loss = model.bce(logits, target, weights)
    grads = torch.autograd.grad(loss, list(leaves.values()))
    return loss.detach(), dict(zip(leaves, grads))


def nested_loss_grads(params, x, target, weights, drop, quant=None,
                      block=256):
    """(loss, {name: gradient}) of one nested step over a patient's
    normalized windows ``x`` (W, S, C, L), every window's logits against
    ``target`` (2,), averaged over the windows ``weights`` keeps."""
    w, s = x.shape[:2]

    def part(i, j):
        return [m[i * s:j * s] for m in drop] if drop is not None else None

    spans = [(i, min(i + block, w)) for i in range(0, w, block)]
    with torch.no_grad():
        medians = torch.cat([model.nested_medians(params, x[i:j], part(i, j),
                                                  quant) for i, j in spans])
    medians.requires_grad_()
    top = {k: v.detach().requires_grad_() for k, v in params.items()
           if not k.startswith("breath_block.")}
    logits = model.lstm_head(top, medians, quant)
    loss = model.bce(logits, target.expand(w, -1), weights)
    got = torch.autograd.grad(loss, [medians] + list(top.values()))
    grads = dict(zip(top, got[1:]))
    names = _backbone_names(params)
    leaves = {k: params[k].detach().requires_grad_() for k in names}
    total = {k: torch.zeros_like(params[k]) for k in names}
    for i, j in spans:
        med = model.nested_medians(leaves, x[i:j], part(i, j), quant)
        for k, g in zip(names, torch.autograd.grad(
                med, list(leaves.values()), grad_outputs=got[0][i:j])):
            total[k] += g
    grads.update(total)
    return loss.detach(), grads


def train_steps(network, weights, raw, targets, steps, mu, std,
                dropout_seed, drawn_rows, hyper, quant=None,
                leave_out_half=False, block=256, masks=None):
    """The first ``len(steps)`` train steps from ``weights``.

    ``steps``: each step's row ids into ``raw`` (N, S, C, L) and
    ``targets`` (N, 2): a batch of samples (cnn_linear) or one patient's
    windows in order (nested).  ``drawn_rows``: the rows each dropout
    draw covers (the padded batch's B*S, or a nested bucket's W*S), of
    which the first are this step's; one number, or one a step.
    ``hyper``: lr, weight_decay, clip.  ``leave_out_half``: a fault, the
    second half of each step's samples or windows left out of the loss
    and the norms.  ``masks``: each step's 0/1 row mask (all ones where
    None).

    Returns {"losses": [...], "first_grad": {name: norm of the clamped
    first gradient}, "first_grad_t": {name: that gradient, on the host},
    "change": {name: norm of the change after the steps}, "grad_norm":
    {name: norm of the first unclamped gradient}}.
    """
    device = raw.device
    params = {k: v.detach().clone().float() for k, v in weights.items()}
    start = {k: v.clone() for k, v in params.items()}
    gen = torch.Generator(device=device).manual_seed(int(dropout_seed))
    momentum, losses = {}, []
    first_grad = grad_norm = None
    if masks is None:
        masks = [None] * len(steps)
    with full_float32():
        if isinstance(drawn_rows, int):
            drawn_rows = [drawn_rows] * len(steps)
        for ids, drawn, mask in zip(steps, drawn_rows, masks):
            ids = torch.as_tensor(ids, device=device)
            x = _normalize(raw.index_select(0, ids), mu, std)
            n = x.shape[0]
            keep = (torch.ones(n, device=device) if mask is None else
                    torch.as_tensor(mask, dtype=torch.float32,
                                    device=device).clone())
            if leave_out_half:
                keep[n - n // 2:] = 0.0
            drop = model.dropout_masks(gen, drawn, device)
            if network == "cnn_linear":
                loss, grads = cnn_linear_loss_grads(
                    params, x, targets.index_select(0, ids), keep, drop,
                    quant)
            else:
                loss, grads = nested_loss_grads(
                    params, x, targets[ids[0]], keep, drop, quant, block)
            if first_grad is None:
                clip = hyper["clip"]
                first_grad = {k: g.clamp(-clip, clip).cpu()
                              for k, g in grads.items()}
                grad_norm = {k: float(g.norm()) for k, g in grads.items()}
            model.sgd_step(params, grads, momentum, hyper["lr"],
                           hyper["weight_decay"], hyper["clip"])
            losses.append(float(loss))
    change = {k: float((params[k] - start[k]).norm()) for k in params}
    return {"losses": losses,
            "first_grad": {k: float(g.norm()) for k, g in first_grad.items()},
            "first_grad_t": first_grad, "change": change,
            "grad_norm": grad_norm, "clip": hyper["clip"]}


def test_logits(weights, raw, ids, masks, mu, std, dropout_seed,
                quant=None):
    """(steps * B, 2) cnn_linear logits of a test epoch whose step k
    scores the rows ``ids[k]`` with row mask ``masks[k]``, dropout drawn
    as the run draws it from ``dropout_seed``."""
    device = raw.device
    params = {k: v.detach().float() for k, v in weights.items()}
    gen = torch.Generator(device=device).manual_seed(int(dropout_seed))
    s = raw.shape[1]
    out = []
    with torch.no_grad(), full_float32():
        for step_ids, step_mask in zip(ids, masks):
            step_ids = torch.as_tensor(step_ids, device=device)
            x = _normalize(raw.index_select(0, step_ids), mu, std)
            drop = model.dropout_masks(gen, x.shape[0] * s, device)
            out.append(model.cnn_linear_logits(
                params, x, torch.as_tensor(step_mask, device=device), drop,
                quant))
    return torch.cat(out)
