#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (deepards_tpu_torch) on one card.

    python3 chip_smoke.py

Run from the root of a checkout on a machine with an NVIDIA H100.  It
builds the CUDA kernels from the checkout's sources with nvcc, holds each
kernel against its plain PyTorch version, then drives the port's main
path: a server over a full-width cnn_linear/densenet18 checkpoint (random
weights from a seed) answering /predict requests, and DTW scoring of the
served windows' breaths through the kernel.  Every phase prints one JSON
line; any failure exits nonzero.  The last two lines are the card's
``nvidia-smi`` name and power limit and
``{"ok": true, "device": {...}}``.  Without a card it exits 1 and prints
no result.
"""
import io
import json
import os
import subprocess
import sys
import tempfile
import threading
import time
import urllib.request

import numpy as np

# full-width served model: densenet18 (growth 32, blocks (2,2,2,2), 64
# initial features, F = 128) under cnn_linear, windows (S, C, L)
S, C, L = 20, 1, 224
BATCH = 16
SEED = 0
PROB_ATOL = 1e-4  # card vs CPU, f32 without TF32: summation order only

# published H100 SXM peaks (NVIDIA data sheet)
HBM_BYTES_PER_S = 3.35e12
F32_OPS_PER_S = 67e12
DTW_OPS_PER_CELL = 5  # subtract, abs, two mins, add


def emit(phase, **fields):
    print(json.dumps({"phase": phase, **fields}), flush=True)


def nvidia_smi_line():
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def cuda_ms(fn, warmup=2, reps=10):
    """Median milliseconds of ``fn`` over ``reps`` runs, CUDA events."""
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return float(np.median(times))


def device_breakdown(fn, reps=5, top=8):
    """torch.profiler over ``reps`` calls of ``fn``: device (kernel) time
    per call, in total and by kernel name, and kernel launches per call."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    kernels = [e for e in prof.key_averages()
               if e.device_type == DeviceType.CUDA]
    busy_us = sum(e.self_device_time_total for e in kernels)
    kernels.sort(key=lambda e: -e.self_device_time_total)
    return {
        "device_ms_per_call": busy_us / reps / 1e3,
        "kernel_launches_per_call": sum(e.count for e in kernels) / reps,
        "top": [{"name": e.key[:80],
                 "ms_per_call": e.self_device_time_total / reps / 1e3,
                 "launches_per_call": e.count / reps}
                for e in kernels[:top]],
    }


def make_pairs(rng, bsz, n, lo, hi):
    """(B, n) zero-padded pairs with lengths drawn in [lo, hi]."""
    a = rng.normal(size=(bsz, n)).astype(np.float32)
    b = rng.normal(size=(bsz, n)).astype(np.float32)
    la = rng.integers(lo, hi + 1, size=bsz).astype(np.int32)
    lb = rng.integers(lo, hi + 1, size=bsz).astype(np.int32)
    a[np.arange(n)[None, :] >= la[:, None]] = 0
    b[np.arange(n)[None, :] >= lb[:, None]] = 0
    return a, b, la, lb


def make_windows(rng, n):
    """(n, S, C, L) flow-like windows: a half-sine inspiration and an
    exponential expiration per breath, random period and amplitude, noise."""
    t = np.arange(L, dtype=np.float64) * 0.02
    period = rng.uniform(2.5, 4.0, size=(n, S, C, 1))
    amp = rng.uniform(30.0, 60.0, size=(n, S, C, 1))
    phase = (t / period + rng.uniform(0, 1, size=(n, S, C, 1))) % 1.0
    flow = np.where(
        phase < 0.35,
        amp * np.sin(np.pi * phase / 0.35),
        -0.8 * amp * np.exp(-8.0 * (phase - 0.35)),
    )
    flow += rng.normal(scale=1.0, size=flow.shape)
    return flow.astype(np.float32)


def phase_env():
    import torch

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    smi = nvidia_smi_line()
    print(smi, flush=True)
    emit("env", nvidia_smi=smi, python=sys.version.split()[0],
         torch=torch.__version__, cuda=torch.version.cuda,
         device=torch.cuda.get_device_name(0),
         device_count=torch.cuda.device_count(),
         cudnn_allow_tf32=torch.backends.cudnn.allow_tf32,
         matmul_allow_tf32=torch.backends.cuda.matmul.allow_tf32)
    return smi


def phase_build():
    from deepards_tpu_torch.ops import build

    t0 = time.perf_counter()
    logs = build.build_all()
    seconds = time.perf_counter() - t0
    ptxas = {
        name: [ln.strip() for ln in log.splitlines()
               if "registers" in ln or "bytes stack" in ln]
        for name, log in logs.items()
    }
    emit("build", seconds=seconds, built=sorted(logs), ptxas=ptxas,
         flags=" ".join(build.NVCC_FLAGS))


def phase_kernel():
    """dtw_cuda against dtw_reference on the card, then timings."""
    import torch

    from deepards_tpu_torch.ops.dtw import dtw_cuda, dtw_numpy, dtw_reference

    rng = np.random.default_rng(SEED)
    dev = torch.device("cuda")

    def on_card(*arrays):
        return [torch.from_numpy(x).to(dev) for x in arrays]

    shapes = []
    max_err = 0.0
    for bsz, n, lo, hi in ((8192, 256, 150, 224), (256, 4480, 2240, 4480),
                           (300, 97, 1, 97)):
        a, b, la, lb = on_card(*make_pairs(rng, bsz, n, lo, hi))
        got = dtw_cuda(a, b, la, lb)
        want = dtw_reference(a, b, la, lb)
        torch.cuda.synchronize()
        err = float((got - want).abs().max())
        if not torch.isfinite(got).all() or err != 0.0:
            raise AssertionError(
                "dtw_cuda != dtw_reference at B={} n={}: max abs {}".format(
                    bsz, n, err))
        max_err = max(max_err, err)
        shapes.append({"B": bsz, "n": n, "lengths": [lo, hi],
                       "max_abs_err": err,
                       "ms": cuda_ms(lambda: dtw_cuda(a, b, la, lb),
                                     warmup=1, reps=5)})

    a, b, la, lb = make_pairs(rng, 8, 224, 150, 224)
    got = dtw_cuda(*on_card(a, b, la, lb)).cpu().numpy()
    oracle = np.array([dtw_numpy(a[i, :la[i]], b[i, :lb[i]])
                       for i in range(8)])
    oracle_rel = float(np.max(np.abs(got - oracle) / np.abs(oracle)))
    if oracle_rel > 1e-4:
        raise AssertionError("dtw_cuda vs f64 oracle rel {}".format(
            oracle_rel))

    # throughput at 65,536 pairs of 224 x 224
    bsz, n = 65536, 224
    a, b, la, lb = on_card(*make_pairs(rng, bsz, n, n, n))
    ms = cuda_ms(lambda: dtw_cuda(a, b, la, lb), warmup=2, reps=20)
    plain_ms = cuda_ms(lambda: dtw_reference(a, b, la, lb),
                       warmup=1, reps=10)
    cells = float((la.double() * lb.double()).sum())
    bytes_moved = 2 * bsz * n * 4 + 2 * bsz * 4 + bsz * 4
    bytes_ms = bytes_moved / HBM_BYTES_PER_S * 1e3
    ops_ms = cells * DTW_OPS_PER_CELL / F32_OPS_PER_S * 1e3
    timing = {
        "B": bsz, "n": n, "ms": ms, "plain_ms": plain_ms,
        "pairs_per_s": bsz / ms * 1e3,
        "plain_pairs_per_s": bsz / plain_ms * 1e3,
        "bound_ms": max(bytes_ms, ops_ms),
        "bound_by": "bytes" if bytes_ms > ops_ms else "operations",
        "bytes_ms": bytes_ms, "ops_ms": ops_ms,
    }
    emit("kernel", shapes=shapes, oracle_max_rel=oracle_rel, timing=timing,
         tolerance="exact vs dtw_reference; rtol 1e-4 vs f64 oracle")
    return {"max_abs_err": max_err, **timing}


def phase_serve(workdir, device="cuda"):
    """Serve a seeded full-width cnn_linear/densenet18 over HTTP."""
    import torch

    from deepards_tpu_torch.cli.serve import (
        InferenceEngine,
        patient_votes,
        serve,
    )
    from deepards_tpu_torch.models.registry import (
        get_base_network,
        get_network_spec,
    )
    from deepards_tpu_torch.train import checkpoint as ckpt

    rng = np.random.default_rng(SEED + 1)
    windows = make_windows(rng, 37)
    patients = np.array(["pt{}".format(i % 3) for i in range(37)])
    conf = {"base_network": "densenet18", "network": "cnn_linear",
            "bn_scope": "sequence"}
    model = get_network_spec("cnn_linear").build(
        conf, get_base_network(conf), S)
    model.reset_parameters(torch.Generator().manual_seed(SEED))
    path = ckpt.save(os.path.join(workdir, "cnn_linear_densenet18.pt"),
                     model.state_dict(),
                     scaling=(windows.mean(), windows.std()))
    engine = InferenceEngine(path, scaling=ckpt.load_scaling(path),
                             device=device)
    if engine.model.breath_block.n_out_filters != 128:
        raise AssertionError("densenet18 must give F = 128 features")
    engine.warm()
    server = serve(engine, "127.0.0.1", 0)
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    url = "http://127.0.0.1:{}/predict".format(server.server_address[1])

    def post(body, ctype):
        req = urllib.request.Request(
            url, data=body, headers={"Content-Type": ctype})
        with urllib.request.urlopen(req, timeout=120) as resp:
            return json.loads(resp.read())

    def npz(**arrays):
        buf = io.BytesIO()
        np.savez(buf, **arrays)
        return buf.getvalue()

    try:
        responses = [
            (1, None, post(json.dumps({"data": windows[:1].tolist()})
                           .encode(), "application/json")),
            (16, None, post(npz(data=windows[:16]),
                            "application/octet-stream")),
            (37, patients, post(npz(data=windows, patients=patients),
                                "application/octet-stream")),
        ]
        repeat = post(npz(data=windows, patients=patients),
                      "application/octet-stream")
    finally:
        server.shutdown()
        server.server_close()
        thread.join(timeout=30)
    if thread.is_alive():
        raise RuntimeError("server thread did not stop")

    for n, pts, resp in responses:
        probs = np.stack([resp["prob_other"], resp["prob_ards"]], axis=1)
        if probs.shape != (n, 2) or not np.isfinite(probs).all():
            raise AssertionError("bad probabilities for {} windows".format(n))
        if np.abs(probs.sum(axis=1) - 1.0).max() > 1e-5:
            raise AssertionError("probabilities do not sum to 1")
        if resp["predictions"] != probs.argmax(axis=1).tolist():
            raise AssertionError("predictions != argmax of probabilities")
        if pts is not None and resp["patient_votes"] != patient_votes(
                probs, pts):
            raise AssertionError("patient_votes disagree with predictions")
    if repeat != responses[-1][2]:
        raise AssertionError("a repeated request got another answer")

    # deterministic forward (dropout off) on the device against the CPU
    x = (windows[:BATCH] - windows.mean()) / windows.std()
    cpu_model = get_network_spec("cnn_linear").build(
        conf, get_base_network(conf), S)
    cpu_model.load_state_dict(model.state_dict())
    with torch.inference_mode():
        want = cpu_model(torch.from_numpy(x), True)
        got = engine.model(torch.from_numpy(x).to(engine.device), True).cpu()
    logit_err = float((got - want).abs().max())
    prob_err = float((got.softmax(-1) - want.softmax(-1)).abs().max())
    if prob_err > PROB_ATOL:
        raise AssertionError("device vs CPU probabilities differ by {}"
                             .format(prob_err))

    # served forward per batch of 16: host clock around predict (scaling,
    # copies both ways and the forward), median of 20 after warm-up
    times = []
    for _ in range(22):
        t0 = time.perf_counter()
        engine.predict(windows[:BATCH])
        times.append((time.perf_counter() - t0) * 1e3)
    fields = {"requests": [n for n, _, _ in responses] + [37],
              "device_vs_cpu_max_abs_logit": logit_err,
              "device_vs_cpu_max_abs_prob": prob_err,
              "prob_atol": PROB_ATOL,
              "predict_ms_per_batch16": float(np.median(times[2:]))}
    if engine.device.type == "cuda":
        xd = torch.from_numpy(windows[:BATCH]).to(engine.device)
        forward_ms = cuda_ms(lambda: engine._forward(xd), warmup=2, reps=20)
        profiled = device_breakdown(lambda: engine._forward(xd))
        fields["forward_ms_per_batch16"] = forward_ms
        fields["forward_profile"] = profiled
        fields["device_idle_share"] = (
            1.0 - profiled["device_ms_per_call"] / forward_ms)
    emit("serve", **fields)
    return windows


def phase_dtw_served(windows, device="cuda"):
    """Rolling per-breath DTW over the served windows on the device,
    against the same scoring on the CPU."""
    from deepards_tpu_torch.dtw.lib import per_breath_dtw_scores

    breaths = list(windows.reshape(-1, C * L))
    t0 = time.perf_counter()
    got = per_breath_dtw_scores(breaths, 3, device=device)
    seconds = time.perf_counter() - t0
    want = per_breath_dtw_scores(breaths, 3, device="cpu")
    if not np.array_equal(np.isnan(got), np.isnan(want)):
        raise AssertionError("NaN pattern differs")
    err = float(np.nanmax(np.abs(got - want)))
    if err != 0.0:
        raise AssertionError("device vs CPU DTW scores differ by {}".format(
            err))
    emit("dtw_served", breaths=len(breaths), pairs=3 * (len(breaths) - 3),
         max_abs_vs_cpu=err, seconds=seconds)


def main():
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False",
              file=sys.stderr)
        return 1
    import deepards_tpu_torch.ops.dtw as dtw_ops
    from deepards_tpu_torch.ops.build import BUILD_DIR

    smi = phase_env()
    phase_build()
    dtw_stats = phase_kernel()

    # the main path: counts from 0 just before it, read just after
    dtw_ops.launches = 0
    BUILD_DIR.mkdir(exist_ok=True)
    with tempfile.TemporaryDirectory(dir=BUILD_DIR) as work:
        windows = phase_serve(work)
    phase_dtw_served(windows)
    launches = dtw_ops.launches
    if launches == 0:
        raise AssertionError("the main path never launched the dtw kernel")

    print(json.dumps({"kernels": [{
        "name": "dtw",
        "route": "cuda",
        "source": "deepards_tpu_torch/ops/csrc/dtw.cu",
        "replaces": "deepards_tpu/ops/dtw.py:119",
        "launches": launches,
        "max_abs_err": dtw_stats["max_abs_err"],
        "ms": dtw_stats["ms"],
        "plain_ms": dtw_stats["plain_ms"],
        "bound_ms": dtw_stats["bound_ms"],
        "bound_by": dtw_stats["bound_by"],
        "library_ms": None,
    }]}), flush=True)
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
