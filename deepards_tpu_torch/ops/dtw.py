"""Batched dynamic time warping.

Counterpart of ``deepards_tpu/ops/dtw.py``.  For each padded pair
(a[p, :la], b[p, :lb]) the batched functions return the unconstrained DTW
cost D[la-1, lb-1] with D[i, j] = |a_i - b_j| + min(D[i-1, j], D[i, j-1],
D[i-1, j-1]).  Inputs are (B, n) float32 plus (B,) int32 lengths in
[1, n].

- ``dtw_reference``: plain PyTorch, any device; mirrors the JAX package's
  ``_dtw_scan_impl`` step for step (2n-1 diagonals, the ``BIG`` sentinel,
  masking by (la, lb)).
- ``dtw_cuda``: the hand-written CUDA kernel ``csrc/dtw.cu`` (CUDA tensors
  only; one warp per strip of rows, any width n); equal to
  ``dtw_reference`` bit for bit.
- ``dtw_batch``: the dispatch.  CUDA tensors go to the kernel, CPU tensors
  to ``dtw_reference``.
- ``dtw_numpy``: the float64 host oracle.
- ``dtw_full``: one pair on the host, with the accumulated-cost matrix
  and the warping path.
"""
import ctypes
import functools

import numpy as np
import torch

from deepards_tpu_torch.device import resolve_device

BIG = 8.5e37  # large-but-finite f32 sentinel (avoids inf-inf NaNs)

# Launches of the CUDA kernel by ``dtw_cuda`` (a plain counter that a run
# resets and reads to show it went through the kernel).
launches = 0


def dtw_numpy(a, b):
    """Plain O(n*m) numpy DP: the correctness oracle."""
    a = np.asarray(a, np.float64)
    b = np.asarray(b, np.float64)
    n, m = len(a), len(b)
    D = np.full((n + 1, m + 1), np.inf)
    D[0, 0] = 0.0
    for i in range(1, n + 1):
        for j in range(1, m + 1):
            cost = abs(a[i - 1] - b[j - 1])
            D[i, j] = cost + min(D[i - 1, j], D[i, j - 1], D[i - 1, j - 1])
    return D[n, m]


def dtw_full(a, b):
    """One pair's DTW with its accumulated-cost matrix and optimal warping
    path (dtwco's ``dtw(x, y, dist_only=False)``), in float64 on the host.

    Returns (distance, cost (n, m), (path_x, path_y)), the path running
    from (0, 0) to (n-1, m-1).  Backtracking is sequential over one pair,
    so this is host code; distances in bulk go through ``dtw_batch``.
    """
    a = np.asarray(a, np.float64)
    b = np.asarray(b, np.float64)
    n, m = len(a), len(b)
    D = np.full((n + 1, m + 1), np.inf)
    D[0, 0] = 0.0
    cost = np.abs(a[:, None] - b[None, :])
    for i in range(1, n + 1):
        D[i, 1:] = cost[i - 1]
        prev = D[i - 1]
        run = D[i]
        for j in range(1, m + 1):
            run[j] += min(prev[j], prev[j - 1], run[j - 1])
    i, j = n - 1, m - 1
    px, py = [i], [j]
    while i > 0 or j > 0:
        if i == 0:
            j -= 1
        elif j == 0:
            i -= 1
        else:
            # diagonal, then up, then left on ties
            step = np.argmin((D[i, j], D[i, j + 1], D[i + 1, j]))
            i -= step in (0, 1)
            j -= step in (0, 2)
        px.append(i)
        py.append(j)
    return (float(D[n, m]), D[1:, 1:],
            (np.asarray(px[::-1]), np.asarray(py[::-1])))


def dtw_reference(a, b, la, lb):
    """Plain PyTorch wavefront over all 2n-1 diagonals of (B, n) pairs.

    Diagonal d holds cell (i, d-i) at lane i.  Returns (B,) float32 on
    ``a``'s device.
    """
    bsz, n = a.shape
    dev = a.device
    i_idx = torch.arange(n, device=dev).unsqueeze(0)
    la = la.to(torch.int64).unsqueeze(1)
    lb = lb.to(torch.int64).unsqueeze(1)
    big_col = torch.full((bsz, 1), BIG, device=dev)
    big = torch.full((bsz, n), BIG, device=dev)
    prev = big
    prev2 = big
    result = torch.zeros(bsz, device=dev)
    for d in range(2 * n - 1):
        j_idx = d - i_idx
        valid = (i_idx <= min(d, n - 1)) & (j_idx >= 0)
        in_len = (i_idx < la) & (j_idx < lb)
        b_diag = b[:, j_idx.clamp(0, n - 1).squeeze(0)]  # b[d-i] at lane i
        cost = torch.abs(a - b_diag)
        up = prev  # (i, j-1)
        left = torch.cat([big_col, prev[:, :-1]], dim=1)  # (i-1, j)
        diag = torch.cat([big_col, prev2[:, :-1]], dim=1)  # (i-1, j-1)
        best = torch.minimum(torch.minimum(up, left), diag)
        if d == 0:  # origin (0, 0) has no predecessors
            best = torch.where(i_idx == 0, torch.zeros_like(best), best)
        cur = torch.where(valid & in_len, cost + best, big)
        # capture D[la-1, lb-1] when this diagonal passes through it
        is_final = (i_idx == la - 1) & (j_idx == lb - 1)
        result = torch.where(
            is_final.any(dim=1),
            torch.where(is_final, cur, torch.zeros_like(cur)).sum(dim=1),
            result,
        )
        prev2, prev = prev, cur
    return result


def _check(name, t, dtype, shape):
    if not t.is_cuda:
        raise ValueError("dtw_cuda: {} must be a CUDA tensor".format(name))
    if t.dtype != dtype:
        raise TypeError("dtw_cuda: {} must be {}, got {}".format(
            name, dtype, t.dtype))
    if tuple(t.shape) != shape:
        raise ValueError("dtw_cuda: {} must have shape {}, got {}".format(
            name, shape, tuple(t.shape)))
    if not t.is_contiguous():
        raise ValueError("dtw_cuda: {} must be contiguous".format(name))


@functools.cache
def _lib():
    """The kernel's library (built at first use) with its C signatures."""
    from deepards_tpu_torch.ops import build

    lib = build.load("dtw")
    ptr = ctypes.c_void_p
    lib.dtw_wavefront.argtypes = [ptr, ptr, ptr, ptr, ptr, ptr, ctypes.c_int,
                                  ctypes.c_int, ptr]
    lib.dtw_wavefront.restype = ctypes.c_int
    lib.dtw_scratch_floats.argtypes = [ctypes.c_int]
    lib.dtw_scratch_floats.restype = ctypes.c_int
    lib.dtw_resident_warps.argtypes = [ctypes.c_int]
    lib.dtw_resident_warps.restype = ctypes.c_int
    lib.dtw_error_string.argtypes = [ctypes.c_int]
    lib.dtw_error_string.restype = ctypes.c_char_p
    return lib


def dtw_cuda(a, b, la, lb):
    """The CUDA kernel on (B, n) float32 CUDA tensors and (B,) int32
    lengths, launched on the current stream.  Returns (B,) float32.  A
    pair whose lengths fall outside [1, n] gets NaN."""
    global launches
    if a.dim() != 2:
        raise ValueError("dtw_cuda: a must be (B, n)")
    bsz, n = a.shape
    _check("a", a, torch.float32, (bsz, n))
    _check("b", b, torch.float32, (bsz, n))
    _check("la", la, torch.int32, (bsz,))
    _check("lb", lb, torch.int32, (bsz,))
    if len({a.device, b.device, la.device, lb.device}) != 1:
        raise ValueError("dtw_cuda: all inputs must be on one device")
    if bsz == 0 or n == 0:
        raise ValueError("dtw_cuda: empty input {}".format(tuple(a.shape)))
    lib = _lib()
    with torch.cuda.device(a.device):
        out = torch.empty(bsz, dtype=torch.float32, device=a.device)
        # the boundary row between strip passes of a pair wider than one
        # block's warps cover; freed on return, the caching allocator hands
        # it only to work queued after the kernel on this stream
        per_pair = lib.dtw_scratch_floats(n)
        edge = (torch.empty((bsz, per_pair), dtype=torch.float32,
                            device=a.device) if per_pair else None)
        stream = torch.cuda.current_stream(a.device).cuda_stream
        err = lib.dtw_wavefront(
            a.data_ptr(), b.data_ptr(), la.data_ptr(), lb.data_ptr(),
            out.data_ptr(), None if edge is None else edge.data_ptr(), bsz,
            n, stream)
    if err != 0:
        raise RuntimeError("dtw_cuda launch failed: {}".format(
            lib.dtw_error_string(err).decode()))
    launches += 1
    return out


def dtw_resident_warps(n):
    """Warps of the kernel ``dtw_cuda`` launches at width ``n`` that one SM
    of the current card holds at once (the CUDA occupancy calculator)."""
    return _lib().dtw_resident_warps(n)


def dtw_batch(a, b, la=None, lb=None, device=None):
    """Batched DTW distances on ``device`` (default: the card).

    a, b: (B, n) or (n,) arrays or tensors, zero-padded; la, lb: (B,)
    true lengths in [1, n] (default: full length).  Returns (B,) float32
    on ``device``: computed by the CUDA kernel there, or by
    ``dtw_reference`` on the CPU.
    """
    device = resolve_device(device)
    a = torch.as_tensor(a, dtype=torch.float32, device=device)
    b = torch.as_tensor(b, dtype=torch.float32, device=device)
    if a.dim() == 1:
        a, b = a[None], b[None]
    bsz, n = a.shape
    if la is None:
        la = torch.full((bsz,), n, dtype=torch.int32)
    if lb is None:
        lb = torch.full((bsz,), n, dtype=torch.int32)
    la = torch.as_tensor(la, dtype=torch.int32, device=device)
    lb = torch.as_tensor(lb, dtype=torch.int32, device=device)
    a, b, la, lb = (t.contiguous() for t in (a, b, la, lb))
    if a.is_cuda:
        return dtw_cuda(a, b, la, lb)
    return dtw_reference(a, b, la, lb)

