"""Processes, the data axis, and the reductions and gathers across them.

Counterpart of ``deepards_tpu/parallel/mesh.py``.  The JAX package runs
each padded batch over a data axis of k devices as one global program
(GSPMD): the norms' statistics, the loss, the gradient and the eval
outputs span the whole batch.  The port gives the same numbers two ways:

- one process with k > 1: the global program on the one device.  All k
  changes is the batch's pad target, ``-(-batch_size // k) * k``;
- k processes (``torch.distributed`` over gloo, one rank a shard): each
  rank holds the contiguous k-th of every padded batch (``shard_batch``).
  Within ``sharded_rows`` the norms' statistics, the losses' row counts
  and dropout's draws span every rank's rows; the optimizer sums the
  gradients over the ranks before its clip and weight decay, and the
  trainers gather the eval outputs (``fetch_global``) so that every rank
  votes on every patient.

gloo is the backend: it is the one that runs two ranks on one card (NCCL
refuses two ranks on the same device).  It reduces and broadcasts CUDA
tensors; its gathers run on host tensors, where the eval outputs go
anyway.  What runs outside ``sharded_rows`` (the stateful fold, the
nested, siamese, detector and parallel-fold trainers, whose batches the
JAX package does not shard, and ProtoPNet's push) runs whole on every
rank, as the JAX package replicates it.
"""
import contextlib
import contextvars
from typing import NamedTuple

import numpy as np
import torch
import torch.distributed as dist

DATA_AXIS = "data"
MODEL_AXIS = "model"

# the DataAxis of the step running in this thread, set by sharded_rows
_SHARDED = contextvars.ContextVar("sharded_rows", default=None)


def initialize_distributed(coordinator_address=None, num_processes=None,
                           process_id=None):
    """Join the group of ``num_processes`` ranks whose rank 0 listens at
    ``coordinator_address`` (host:port) as rank ``process_id``, over gloo.
    Call it once, before any work on a device.  A no-op for one process,
    or when this process has joined already."""
    if not coordinator_address or (num_processes or 1) <= 1:
        return
    if dist.is_initialized():
        return
    if process_id is None:
        raise ValueError("--process-id is needed with --num-processes {}"
                         .format(num_processes))
    dist.init_process_group(
        "gloo", init_method="tcp://" + coordinator_address,
        world_size=num_processes, rank=process_id)


def process_count():
    return dist.get_world_size() if dist.is_initialized() else 1


def process_index():
    return dist.get_rank() if dist.is_initialized() else 0


class DataAxis(NamedTuple):
    """A run's data axis: every padded batch is ``size`` equal contiguous
    shards, held by ``world`` processes (1: all of them here; ``size``:
    one a rank), this one rank ``rank``."""

    size: int = 1
    rank: int = 0
    world: int = 1

    @property
    def sharded(self):
        return self.world > 1

    def pad_target(self, batch_size):
        """The padded batch: ``batch_size`` up to a multiple of ``size``."""
        return -(-batch_size // self.size) * self.size

    def local(self, n_rows):
        """This process's rows of ``n_rows`` padded rows, as a slice."""
        per = n_rows // self.world
        return slice(self.rank * per, (self.rank + 1) * per)


def make_data_axis(dp_devices=-1):
    """The data axis ``dp_devices`` asks for: -1 (or None, 0) is the
    number of processes.  One process takes any k >= 1 and runs the k
    shards itself; a run of n > 1 processes takes 1 (every rank runs the
    whole batch) or n (one shard a rank), and refuses any other k."""
    world = process_count()
    size = world if dp_devices in (None, 0, -1) else int(dp_devices)
    if size < 1:
        raise ValueError("dp_devices={}: the data axis needs at least one "
                         "device".format(dp_devices))
    if world > 1 and size not in (1, world):
        raise ValueError(
            "dp_devices={}: a run of {} processes takes dp_devices -1, 1 "
            "or {}".format(dp_devices, world, world))
    if world > 1 and size == world:
        return DataAxis(size, process_index(), world)
    return DataAxis(size)


def shard_batch(axis, batch):
    """``batch`` (a dict of arrays with one leading row count b) padded
    with zero rows to a multiple of ``axis.size``, and the row mask (1 a
    real row, 0 a pad row), each cut to this process's contiguous rows,
    as ``deepards_tpu/parallel/mesh.py:66-96`` places them on the mesh.
    Returns (rows, mask)."""
    b = next(iter(batch.values())).shape[0]
    pad = (-b) % axis.size
    mask = np.ones(b + pad, np.float32)
    mask[b:] = 0.0
    rows = axis.local(b + pad)
    out = {k: np.concatenate([v, np.zeros((pad,) + v.shape[1:], v.dtype)])
           [rows] for k, v in batch.items()}
    return out, mask[rows]


def fetch_global(axis, x, dim=0):
    """``x``, this process's rows along ``dim``, as the whole array on the
    host: every rank's rows in rank order (``fetch_global``,
    ``deepards_tpu/parallel/mesh.py:103-124``)."""
    x = x.detach().cpu()
    if not axis.sharded:
        return x.numpy()
    parts = [torch.empty_like(x) for _ in range(axis.world)]
    dist.all_gather(parts, x.contiguous())
    return torch.cat(parts, dim).numpy()


def replicate_tree(tensors):
    """Rank 0's values of ``tensors`` (a model's parameters) on every
    rank, in place; a no-op in one process."""
    if process_count() == 1:
        return
    with torch.no_grad():
        for t in tensors:
            dist.broadcast(t.data, src=0)


def broadcast_object(obj):
    """Rank 0's ``obj`` (picklable) on every rank."""
    if process_count() == 1:
        return obj
    box = [obj]
    dist.broadcast_object_list(box, src=0)
    return box[0]


class _AllReduceSum(torch.autograd.Function):
    """The sum over the ranks; its gradient is the sum of the ranks'
    gradients, since every rank's loss reads the sum."""

    @staticmethod
    def forward(ctx, x):
        x = x.clone()
        dist.all_reduce(x)
        return x

    @staticmethod
    def backward(ctx, grad):
        grad = grad.clone()
        dist.all_reduce(grad)
        return grad


@contextlib.contextmanager
def sharded_rows(axis):
    """Scope a step whose batch rows are this process's shard of
    ``axis``: ``current_sharding`` gives the axis inside it when the
    shards span processes, else None."""
    if axis is None or not axis.sharded:
        yield
        return
    token = _SHARDED.set(axis)
    try:
        yield
    finally:
        _SHARDED.reset(token)


def current_sharding():
    return _SHARDED.get()


def global_sum(x):
    """Inside ``sharded_rows``, the sum of ``x`` over the ranks (with its
    gradient); else ``x``."""
    if _SHARDED.get() is None:
        return x
    return _AllReduceSum.apply(x)


def sum_gradients(grads):
    """Inside ``sharded_rows``, each of ``grads`` summed over the ranks in
    place, in one all-reduce."""
    if _SHARDED.get() is None or not grads:
        return
    flat = torch.cat([g.reshape(-1) for g in grads])
    dist.all_reduce(flat)
    offset = 0
    for g in grads:
        g.copy_(flat[offset:offset + g.numel()].view_as(g))
        offset += g.numel()


# the head Dense's weight (out, F) split by rows over the model axis and
# its bias (out,) split, everything else replicated: the port's names
# and layouts of deepards_tpu/parallel/mesh.py:148-155
HEAD_DENSE_MODEL_RULES = (
    ("head.weight", (MODEL_AXIS, None)),
    ("head.bias", (MODEL_AXIS,)),
)


def placement(name, shape, mesh_shape, rules=()):
    """The split of the parameter ``name`` of ``shape`` over a mesh of
    ``mesh_shape`` ({axis: size}), as ``shard_state`` chooses it
    (``deepards_tpu/parallel/mesh.py:158-188``): the spec of the first
    rule whose pattern is in the name, whose axes are all larger than 1
    and whose split dimensions divide evenly; else () (replicated)."""
    for pattern, spec in rules:
        sizes = [mesh_shape[a] for a in spec if a is not None]
        if (pattern in name and len(shape) >= len(spec)
                and all(s > 1 for s in sizes)
                and all(a is None or shape[i] % mesh_shape[a] == 0
                        for i, a in enumerate(spec))):
            return spec
    return ()
