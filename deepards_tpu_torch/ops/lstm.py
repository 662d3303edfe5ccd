"""The LSTM's recurrence over S time steps.

Given ``xi`` = x W_i^T (B, S, 4H), the recurrent kernel ``w_h`` (4H, H),
its bias ``b_h`` (4H,) and a carry (c, h) of (B, H), all but ``xi`` in
the carry type, each step computes flax's ``OptimizedLSTMCell``: gates
(i, f, g, o) = (h W_h^T + b_h) + xi[:, t], i, f, o through a sigmoid, g
through tanh, c = f c + i g, h = o tanh(c).  Returns ((c, h), (B, S, H)
outputs) in the carry type.

- ``lstm_reference``: the plain version, a Python loop of stock ops on
  any device.  It is the CPU's path, the path under a ``torch.func``
  transform (``vmap`` has no rule for a hand kernel) and the yardstick of
  the kernel's tests.
- ``lstm_cuda``: ``csrc/lstm.cu``, one persistent launch forward and one
  backward (a ``torch.autograd.Function``); CUDA tensors and a plan of
  ``lstm_plan`` only.  The backward kernel gives the gates' gradient, from
  which the wrapper takes dW_h, db_h and dxi with one product or sum each
  over all B * S rows.
- ``recurrence``: the dispatch, decided up front from what it can see
  (device, an active transform, B, H, the carry type) by ``kernel_plan``;
  it counts the steps it ran as ``lstm.kernel_steps`` or
  ``lstm.loop_steps`` (``utils/profiling.count``; under a CUDA graph at
  capture).
"""
import ctypes
import functools
from typing import NamedTuple

import torch
import torch.nn.functional as F
from torch.autograd.function import once_differentiable

from deepards_tpu_torch.utils import profiling

# Launches of the CUDA kernels by ``lstm_cuda``, forward and backward (a
# plain counter that a run resets and reads to show it went through them).
launches = 0

# the plan's limits, as csrc/lstm.cu checks them
WEIGHT_BYTES = 64 * 1024  # a block's slice of W_h, held in registers
MAX_THREADS = 512
MAX_SMEM = 48 * 1024
CLUSTERS = (1, 2, 4, 8)
PARTS = (1, 2, 4, 8)
# weights a thread: the kernels built (more at float32, whose H reaches
# further within WEIGHT_BYTES)
KS = {torch.float32: (16, 32), torch.float64: (16,)}
SMS = 132  # an H100 SXM's SMs, for a plan made without a card


class LSTMPlan(NamedTuple):
    """How the kernels cut a recurrence: clusters of ``cluster`` blocks,
    each block ``units`` hidden units, ``parts`` threads a gate row,
    ``k`` weights a thread, ``rows`` batch rows a cluster."""

    cluster: int
    units: int
    parts: int
    k: int
    rows: int
    threads: int
    blocks: int


def lstm_plan(batch, hidden, dtype, sms=SMS):
    """The kernels' plan for ``batch`` rows of ``hidden`` units in carry
    type ``dtype``, or None where they take none (a carry type other than
    float32 and float64, or a W_h too large for 8 blocks' registers).

    The smallest cluster whose blocks' slices of W_h (4 U H values) stay
    within WEIGHT_BYTES; the fewest parts a gate row that leave a thread
    at most 16 weights (else 32, float32 only) within MAX_THREADS a batch
    row; then as
    many batch rows a cluster as spread ``batch`` over the ``sms`` SMs,
    within MAX_THREADS and MAX_SMEM a block."""
    if dtype not in (torch.float32, torch.float64) or batch < 1 \
            or hidden < 1:
        return None
    elem = torch.finfo(dtype).bits // 8
    for cluster in CLUSTERS:
        units = -(-hidden // cluster)
        if 4 * units * hidden * elem > WEIGHT_BYTES:
            continue
        fits = [p for p in PARTS if 4 * units * p <= MAX_THREADS]
        parts = next((p for limit in KS[dtype] for p in fits
                      if -(-hidden // p) <= limit), None)
        if parts is None:
            continue
        k = next(k for k in KS[dtype] if k * parts >= hidden)
        row_threads = 4 * units * parts
        most = min(MAX_THREADS // row_threads,
                   MAX_SMEM // (8 * k * parts * elem))
        if most < 1:
            continue
        rows = min(most, -(-batch // max(1, sms // cluster)))
        return LSTMPlan(
            cluster=cluster, units=units, parts=parts, k=k, rows=rows,
            threads=-(-rows * row_threads // 32) * 32,
            blocks=-(-batch // rows) * cluster)
    return None


@functools.cache
def _sms(index):
    return torch.cuda.get_device_properties(index).multi_processor_count


def transform_active():
    """Whether a ``torch.func`` transform (``vmap``, ``grad``) is tracing
    the caller."""
    return torch._C._functorch.maybe_current_level() is not None


def kernel_plan(xi, w_h):
    """The plan ``recurrence`` launches the kernels with, or None where it
    runs ``lstm_reference``: ``xi`` not on the card, a ``torch.func``
    transform active, no time step, or no plan for (B, H, carry type)."""
    if not xi.is_cuda or transform_active() or xi.shape[1] < 1:
        return None
    return lstm_plan(xi.shape[0], w_h.shape[1], w_h.dtype,
                     _sms(xi.device.index))


def recurrence(xi, w_h, b_h, c, h):
    """((c, h), outputs) through the kernels where ``kernel_plan`` gives a
    plan, else through ``lstm_reference``."""
    plan = kernel_plan(xi, w_h)
    if plan is not None:
        profiling.count("lstm.kernel_steps", xi.shape[1])
        return lstm_cuda(xi, w_h, b_h, c, h, plan)
    profiling.count("lstm.loop_steps", xi.shape[1])
    return lstm_reference(xi, w_h, b_h, c, h)


def lstm_reference(xi, w_h, b_h, c, h):
    """The plain version: S steps of stock ops."""
    outs = []
    for s in range(xi.shape[1]):
        gates = F.linear(h, w_h, b_h) + xi[:, s]
        i, f, g, o = gates.chunk(4, dim=-1)
        c = torch.sigmoid(f) * c + torch.sigmoid(i) * torch.tanh(g)
        h = torch.sigmoid(o) * torch.tanh(c)
        outs.append(h)
    return (c, h), torch.stack(outs, dim=1)


@functools.cache
def _lib():
    """The kernels' library (built at first use) with its C signatures."""
    from deepards_tpu_torch.ops import build

    lib = build.load("lstm")
    ptr, num = ctypes.c_void_p, ctypes.c_int
    lib.lstm_forward.argtypes = [num, num] + [ptr] * 10 + [num] * 7 + [ptr]
    lib.lstm_forward.restype = num
    lib.lstm_backward.argtypes = [num] + [ptr] * 10 + [num] * 7 + [ptr]
    lib.lstm_backward.restype = num
    lib.lstm_barrier_probe.argtypes = [num] * 4 + [ptr, ptr]
    lib.lstm_barrier_probe.restype = num
    lib.lstm_error_string.argtypes = [num]
    lib.lstm_error_string.restype = ctypes.c_char_p
    return lib


def _raise_on(err, what):
    if err != 0:
        raise RuntimeError("lstm_cuda {} launch failed: {}".format(
            what, _lib().lstm_error_string(err).decode()))


def _ptr(t):
    return None if t is None else t.data_ptr()


def _carry_code(dtype):
    return 1 if dtype == torch.float64 else 0


def _check(xi, w_h, b_h, c, h):
    bsz, steps, four_h = xi.shape
    hidden = w_h.shape[1]
    want = {"w_h": (w_h, (4 * hidden, hidden)), "b_h": (b_h, (4 * hidden,)),
            "c": (c, (bsz, hidden)), "h": (h, (bsz, hidden))}
    if four_h != 4 * hidden:
        raise ValueError("lstm_cuda: xi must be (B, S, {}), got {}".format(
            4 * hidden, tuple(xi.shape)))
    for name, (t, shape) in want.items():
        if tuple(t.shape) != shape:
            raise ValueError("lstm_cuda: {} must have shape {}, got {}"
                             .format(name, shape, tuple(t.shape)))
        if t.dtype != w_h.dtype or t.device != xi.device:
            raise TypeError("lstm_cuda: {} must be {} on {}".format(
                name, w_h.dtype, xi.device))
    if not xi.is_cuda:
        raise ValueError("lstm_cuda: xi must be a CUDA tensor")


def _forward(plan, xi, w_h, b_h, c0, h0, save):
    """Launch the forward kernel: (out, c, h, gates, cells), the last two
    None unless ``save``."""
    global launches
    bsz, steps, four_h = xi.shape
    hidden = four_h // 4
    dtype = w_h.dtype
    if not (xi.dtype == dtype or (xi.dtype == torch.bfloat16
                                  and dtype == torch.float32)):
        xi = xi.to(dtype)  # exact: to a wider type
    xi, w_h, b_h, c0, h0 = (t.contiguous() for t in (xi, w_h, b_h, c0, h0))
    new = functools.partial(torch.empty, dtype=dtype, device=xi.device)
    out = new((bsz, steps, hidden))
    c_last, h_last = new((bsz, hidden)), new((bsz, hidden))
    gates = new((bsz, steps, four_h)) if save else None
    cells = new((bsz, steps, hidden)) if save else None
    with torch.cuda.device(xi.device):
        stream = torch.cuda.current_stream(xi.device).cuda_stream
        err = _lib().lstm_forward(
            _carry_code(dtype), int(xi.dtype == torch.bfloat16),
            xi.data_ptr(), w_h.data_ptr(), b_h.data_ptr(), c0.data_ptr(),
            h0.data_ptr(), out.data_ptr(), c_last.data_ptr(),
            h_last.data_ptr(), _ptr(gates), _ptr(cells), bsz, steps, hidden,
            plan.cluster, plan.parts, plan.rows, plan.k, stream)
    _raise_on(err, "forward")
    launches += 1
    return out, c_last, h_last, gates, cells


def _backward(plan, w_h, gates, cells, c0, dout, dc_last, dh_last,
              want_carry):
    """Launch the backward kernel: (dgates, dc0, dh0), the last two None
    unless ``want_carry``."""
    global launches
    bsz, steps, four_h = gates.shape
    hidden = four_h // 4
    dtype = w_h.dtype
    dout, dc_last, dh_last = (t.to(dtype).contiguous()
                              for t in (dout, dc_last, dh_last))
    new = functools.partial(torch.empty, dtype=dtype, device=gates.device)
    dgates = new((bsz, steps, four_h))
    dc0 = new((bsz, hidden)) if want_carry else None
    dh0 = new((bsz, hidden)) if want_carry else None
    with torch.cuda.device(gates.device):
        stream = torch.cuda.current_stream(gates.device).cuda_stream
        err = _lib().lstm_backward(
            _carry_code(dtype), w_h.data_ptr(), gates.data_ptr(),
            cells.data_ptr(), c0.data_ptr(), dout.data_ptr(),
            dc_last.data_ptr(), dh_last.data_ptr(), dgates.data_ptr(),
            _ptr(dc0), _ptr(dh0), bsz, steps, hidden, plan.cluster,
            plan.parts, plan.rows, plan.k, stream)
    _raise_on(err, "backward")
    launches += 1
    return dgates, dc0, dh0


class _Recurrence(torch.autograd.Function):
    @staticmethod
    def forward(ctx, xi, w_h, b_h, c0, h0, plan):
        out, c_last, h_last, gates, cells = _forward(
            plan, xi, w_h, b_h, c0, h0, save=True)
        ctx.plan = plan
        ctx.xi_dtype = xi.dtype
        ctx.save_for_backward(w_h, c0, h0, out, gates, cells)
        return out, c_last, h_last

    @staticmethod
    @once_differentiable
    def backward(ctx, dout, dc_last, dh_last):
        w_h, c0, h0, out, gates, cells = ctx.saved_tensors
        need = ctx.needs_input_grad
        dgates, dc0, dh0 = _backward(
            ctx.plan, w_h.contiguous(), gates, cells, c0.contiguous(), dout,
            dc_last, dh_last, want_carry=need[3] or need[4])
        four_h = dgates.shape[-1]
        flat = dgates.reshape(-1, four_h)
        dxi = dgates.to(ctx.xi_dtype) if need[0] else None
        dw_h = None
        if need[1]:  # the step's input h_{t-1}, all B * S rows at once
            prev = torch.cat([h0[:, None], out[:, :-1]], dim=1)
            dw_h = flat.T @ prev.reshape(-1, four_h // 4)
        db_h = flat.sum(0) if need[2] else None
        return (dxi, dw_h, db_h, dc0 if need[3] else None,
                dh0 if need[4] else None, None)


def lstm_cuda(xi, w_h, b_h, c, h, plan):
    """The kernels on CUDA tensors under ``plan`` (``lstm_plan``'s for
    these shapes): ((c, h), outputs), differentiable in every input.  A
    forward that no gradient can reach saves nothing for a backward."""
    _check(xi, w_h, b_h, c, h)
    if torch.is_grad_enabled() and any(
            t.requires_grad for t in (xi, w_h, b_h, c, h)):
        out, c_last, h_last = _Recurrence.apply(xi, w_h, b_h, c, h, plan)
    else:
        out, c_last, h_last, _, _ = _forward(plan, xi, w_h, b_h, c, h,
                                             save=False)
    return (c_last, h_last), out


def barrier_probe_ms(cluster, threads, steps, reps=5):
    """Device milliseconds of ``steps`` hand-offs and cluster barriers in
    one cluster of ``cluster`` blocks of ``threads`` on the current card:
    the floor under a recurrence of ``steps`` steps with no arithmetic
    (CUDA events, the median of ``reps`` launches after one to warm
    up)."""
    out = torch.empty(cluster, device="cuda")
    stream = torch.cuda.current_stream(out.device)

    def launch():
        _raise_on(_lib().lstm_barrier_probe(
            cluster, cluster, threads, steps, out.data_ptr(),
            stream.cuda_stream), "barrier probe")

    launch()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record(stream)
        launch()
        end.record(stream)
        end.synchronize()
        times.append(start.elapsed_time(end))
    if float(out.min()) != steps:
        raise AssertionError("barrier probe: {} hand-offs, {} counted"
                             .format(steps, out.tolist()))
    return sorted(times)[len(times) // 2]
