"""The reference's runs that a check compares: the first train steps of a
fold from given weights, and a test epoch's logits, of any network whose
module ``reference/networks`` finds by name.

Each run normalizes the raw windows by the fold's (mean, std), draws its
dropout masks from a generator seeded as the run's is, step after step
and layer after layer, and computes in float32 with TF32 off.  A step of
samples is one autograd graph.  A patient's step splits at the
backbone's per-breath features: the backbone runs in blocks of windows,
first without autograd; the network's head gives the loss, the
features' gradient and its own leaves' gradients; then each block runs
again with autograd, fed its share of that gradient, so the memory holds
one block's activations.
"""
import contextlib

import torch

from benchmark.reference import model, networks


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


def samples_loss_grads(net, params, x, target, weights, drop, quant=None):
    """(loss, {name: gradient}) of one step over a batch of samples:
    normalized windows ``x`` (B, S, C, L), their ``target`` (B, 2)."""
    leaves = {k: v.detach().requires_grad_() for k, v in params.items()}
    feats = model.features(leaves, x, False, drop, weights, quant)
    loss = model.bce(net.logits(leaves, feats, quant), target, weights)
    grads = torch.autograd.grad(loss, list(leaves.values()))
    return loss.detach(), dict(zip(leaves, grads))


def head_loss_grads(net, head, feats, target, weights, quant=None):
    """(loss, the features' gradient, {name: gradient}) of the leaves
    ``head`` past the backbone, over a patient's per-breath features
    ``feats`` (W, S, F): the network's own ``loss_grads``, or autograd
    through its ``logits``."""
    own = getattr(net, "loss_grads", None)
    if own is not None:
        return own(head, feats, target, weights, quant)
    feats = feats.detach().requires_grad_()
    leaves = {k: v.detach().requires_grad_() for k, v in head.items()}
    loss = model.bce(net.logits(leaves, feats, quant), target, weights)
    got = torch.autograd.grad(loss, [feats] + list(leaves.values()))
    return loss.detach(), got[0], dict(zip(leaves, got[1:]))


def _spans(w, block):
    return [(i, min(i + block, w)) for i in range(0, w, block)]


def _part(drop, s, i, j):
    """The dropout masks of windows i to j of a patient of S breaths a
    window."""
    return [m[i * s:j * s] for m in drop] if drop is not None else None


def patient_features(params, x, drop, quant=None, block=256):
    """(W, S, F) per-breath features of a patient's normalized windows
    ``x`` (W, S, C, L), without autograd, a block of windows at a time."""
    s = x.shape[1]
    with torch.no_grad():
        return torch.cat([
            model.features(params, x[i:j], True, _part(drop, s, i, j),
                           quant=quant)
            for i, j in _spans(x.shape[0], block)])


def patient_loss_grads(net, params, x, target, weights, drop, quant=None,
                       block=256):
    """(loss, {name: gradient}) of one step over a patient's normalized
    windows ``x`` (W, S, C, L), every window's logits against ``target``
    (W, 2), averaged over the windows ``weights`` keeps."""
    s = x.shape[1]
    feats = patient_features(params, x, drop, quant, block)
    head = {k: v for k, v in params.items()
            if not k.startswith(model.BACKBONE)}
    loss, dfeats, grads = head_loss_grads(net, head, feats, target, weights,
                                          quant)
    names = [k for k in params if k.startswith(model.BACKBONE)]
    leaves = {k: params[k].detach().requires_grad_() for k in names}
    total = {k: torch.zeros_like(params[k]) for k in names}
    for i, j in _spans(x.shape[0], block):
        part = model.features(leaves, x[i:j], True, _part(drop, s, i, j),
                              quant=quant)
        for k, g in zip(names, torch.autograd.grad(
                part, list(leaves.values()), grad_outputs=dfeats[i:j])):
            total[k] += g
    grads.update(total)
    return loss, grads


def _per_step(drawn_rows, steps):
    if isinstance(drawn_rows, int):
        return [drawn_rows] * len(steps)
    return drawn_rows


def train_steps(network, weights, raw, targets, steps, mu, std,
                dropout_seed, drawn_rows, hyper, quant=None,
                leave_out_half=False, block=256, masks=None):
    """The first ``len(steps)`` train steps from ``weights``.

    ``steps``: each step's row ids into ``raw`` (N, S, C, L) and
    ``targets`` (N, 2): a batch of samples or one patient's windows in
    order, as the network's ``STEP`` says; a patient's target is its
    first row's.  ``drawn_rows``: the rows each dropout draw covers (the
    padded batch's B*S, or a patient's bucket's W*S), of which the first
    are this step's; one number, or one a step.  ``hyper``: lr,
    weight_decay, clip.  ``leave_out_half``: a fault, the second half of
    each step's samples or windows left out of the loss and the norms.
    ``masks``: each step's 0/1 row mask (all ones where None).

    Returns {"losses": [...], "first_grad": {name: norm of the clamped
    first gradient}, "first_grad_t": {name: that gradient, on the host},
    "change": {name: norm of the change after the steps}, "grad_norm":
    {name: norm of the first unclamped gradient}}.
    """
    net = networks.load(network)
    device = raw.device
    params = {k: v.detach().clone().float() for k, v in weights.items()}
    start = {k: v.clone() for k, v in params.items()}
    gen = torch.Generator(device=device).manual_seed(int(dropout_seed))
    momentum, losses = {}, []
    first_grad = grad_norm = None
    if masks is None:
        masks = [None] * len(steps)
    with full_float32():
        for ids, drawn, mask in zip(steps, _per_step(drawn_rows, steps),
                                    masks):
            ids = torch.as_tensor(ids, device=device)
            x = _normalize(raw.index_select(0, ids), mu, std)
            n = x.shape[0]
            keep = (torch.ones(n, device=device) if mask is None else
                    torch.as_tensor(mask, dtype=torch.float32,
                                    device=device).clone())
            if leave_out_half:
                keep[n - n // 2:] = 0.0
            drop = model.dropout_masks(gen, drawn, device)
            if net.STEP == "samples":
                loss, grads = samples_loss_grads(
                    net, params, x, targets.index_select(0, ids), keep, drop,
                    quant)
            else:
                loss, grads = patient_loss_grads(
                    net, params, x, targets[ids[0]].expand(n, -1), keep,
                    drop, quant, block)
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


def test_logits(network, weights, raw, targets, steps, masks, mu, std,
                dropout_seed, drawn_rows, quant=None, block=256):
    """([each step's (n, 2) logits], [each step's loss]) of a test epoch
    whose step k scores the rows ``steps[k]`` of ``raw`` with the 0/1 row
    mask ``masks[k]``, dropout drawn as the run draws it from
    ``dropout_seed`` over ``drawn_rows`` rows a step (one number, or one
    a step).  A batch of samples drops its masked rows from the norms'
    statistics; a patient's windows are normalized each on its own, so
    its mask weighs the loss alone."""
    net = networks.load(network)
    device = raw.device
    params = {k: v.detach().float() for k, v in weights.items()}
    gen = torch.Generator(device=device).manual_seed(int(dropout_seed))
    out = []
    with torch.no_grad(), full_float32():
        for step_ids, drawn, step_mask in zip(
                steps, _per_step(drawn_rows, steps), masks):
            step_ids = torch.as_tensor(step_ids, device=device)
            x = _normalize(raw.index_select(0, step_ids), mu, std)
            drop = model.dropout_masks(gen, drawn, device)
            if net.STEP == "samples":
                feats = model.features(
                    params, x, False, drop,
                    torch.as_tensor(step_mask, device=device), quant)
            else:
                feats = patient_features(params, x, drop, quant, block)
            out.append(net.logits(params, feats, quant))
    losses = [float(model.bce(
        logits, targets.index_select(0, torch.as_tensor(ids, device=device)),
        torch.as_tensor(mask, dtype=torch.float32, device=device)))
        for logits, ids, mask in zip(out, steps, masks)]
    return out, losses
