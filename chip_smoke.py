#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (deepards_tpu_torch) on one card.

    python3 chip_smoke.py

Run from the root of a checkout on a machine with an NVIDIA H100.  It
builds the CUDA kernels from the checkout's sources with nvcc, holds each
kernel against its plain PyTorch version (the DTW kernel exactly, at six
shapes, each timed beside a bound computed from the FP32 instructions per
cell in the kernel's SASS and the card's SM clock), then drives the port's
main path: a server over a full-width cnn_linear/densenet18 checkpoint (random
weights from a seed) answering /predict requests, and DTW scoring of the
served windows' breaths through the kernel.  Then the training path:
benchmark config 1 trained through ``deepards_tpu_torch.cli.train`` on a
seeded synthetic cohort (5 folds, 2 epochs, every step a CUDA-graph
replay), three steps held against the CPU in float32 and float64, a
trained checkpoint served, and the bf16 step and a 4096-window epoch
timed eagerly and as graph replays.  ``graph_vs_eager`` holds 8 graphed
device-cache steps of config 1 to the same steps run eagerly, and
``config1_surface`` drives the rest of config 1's trainer through the CLI
(augmentation, the Butterworth filter, fused host epochs, step
checkpoints and a resume that must reproduce the run, ``cli.predict``
against the trainer's eval, the metadata input, the FFT channels).
Then the DTW heterogeneity workflow: ``dtw_similarity`` scores the
inter-patient matrix of a seeded 80-patient cohort (158,000 window pairs
at n = 4480 through the kernel), holds pairs of the sweep to
``dtw_reference`` and a sub-cohort to the CPU exactly, times host pad,
copy and kernel, and picks the hetero split files on the matrix;
``hetero`` drives the study's CLIs on an ETL cohort (``cli.sim_dissim
hetero``, ``cli.perform_data_splitting``, a holdout ``cli.train``,
``breakdown`` and a cached ``cli.analysis lstm-dtw``).
Every phase prints one JSON line; any failure exits nonzero.  The last
two lines are the card's ``nvidia-smi`` name and power limit and
``{"ok": true, "device": {...}}``.  Without a card it exits 1 and prints
no result.
"""
import io
import json
import os
import re
import subprocess
import sys
import tempfile
import threading
import time
import urllib.request
from collections import Counter

import numpy as np

# full-width served model: densenet18 (growth 32, blocks (2,2,2,2), 64
# initial features, F = 128) under cnn_linear, windows (S, C, L)
S, C, L = 20, 1, 224
BATCH = 16
SEED = 0
PROB_ATOL = 1e-4  # card vs CPU, f32 without TF32: summation order only

# benchmark config 1
# (deepards_tpu/config/experiment_files/unpadded_centered_nb20_cnn_linear.yml)
# as training flags: the card's machine has no PyYAML to read the file.
# Its `random_kfold: false` is the flag's default.
CONFIG1_FLAGS = [
    "--clip-val", "0.01", "--clip-grad",
    "--dataset-type", "unpadded_centered_sequences",
    "--oversample-minority", "--kfolds", "5", "--epochs", "10",
    "--batch-size", "16", "--network", "cnn_linear", "--n-sub-batches", "20",
]

# published H100 SXM peaks (NVIDIA data sheet)
HBM_BYTES_PER_S = 3.35e12
F32_OPS_PER_S = 67e12
SM_FP32_LANES = 128  # FP32 instructions a Hopper SM issues per clock
# the earlier yardstick: 5 "ops" per cell against 67 TFLOP/s, a peak that
# counts an FMA as two operations (a DTW cell has no FMA), so about 2x
# too tight; kept beside the bound restated from the SASS
DTW_OPS_PER_CELL_FLOPS = 5


def emit(phase, **fields):
    print(json.dumps({"phase": phase, **fields}), flush=True)


def nvidia_smi(query, units=True):
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=" + query,
         "--format=csv,noheader" + ("" if units else ",nounits")],
        capture_output=True, text=True, check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def nvidia_smi_line():
    return nvidia_smi("name,power.limit")


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


# runtime calls by which the host puts work on the card's stream
HOST_DISPATCHES = ("cudaLaunchKernel", "cudaLaunchKernelExC",
                   "cuLaunchKernel", "cuLaunchKernelEx", "cudaGraphLaunch",
                   "cudaMemcpyAsync", "cudaMemsetAsync")


def kernel_events(events):
    """The profiler's device events that are kernels: it also lists user
    annotations (such as an optimizer's step) on the device's timeline."""
    from torch.autograd import DeviceType

    return [e for e in events if e.device_type == DeviceType.CUDA
            and not getattr(e, "is_user_annotation", False)]


def device_breakdown(fn, reps=5, top=8):
    """torch.profiler over ``reps`` calls of ``fn``: device (kernel) time
    per call, in total and by kernel name, and kernel launches per call."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    events = prof.key_averages()
    kernels = kernel_events(events)
    busy_us = sum(e.self_device_time_total for e in kernels)
    kernels.sort(key=lambda e: -e.self_device_time_total)
    return {
        "device_ms_per_call": busy_us / reps / 1e3,
        "kernel_launches_per_call": sum(e.count for e in kernels) / reps,
        "host_dispatches_per_call": sum(
            e.count for e in events if e.key in HOST_DISPATCHES) / reps,
        "top": [{"name": e.key[:80],
                 "ms_per_call": e.self_device_time_total / reps / 1e3,
                 "launches_per_call": e.count / reps}
                for e in kernels[:top]],
    }


def post(url, body, ctype):
    req = urllib.request.Request(url, data=body,
                                 headers={"Content-Type": ctype})
    with urllib.request.urlopen(req, timeout=120) as resp:
        return json.loads(resp.read())


def npz(**arrays):
    buf = io.BytesIO()
    np.savez(buf, **arrays)
    return buf.getvalue()


def make_windows(rng, n, s=S):
    """(n, s, C, L) flow-like windows: a half-sine inspiration and an
    exponential expiration per breath, random period and amplitude, noise."""
    t = np.arange(L, dtype=np.float64) * 0.02
    period = rng.uniform(2.5, 4.0, size=(n, s, C, 1))
    amp = rng.uniform(30.0, 60.0, size=(n, s, C, 1))
    phase = (t / period + rng.uniform(0, 1, size=(n, s, C, 1))) % 1.0
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
    emit("env", nvidia_smi=smi, sm_clock_max_mhz=sm_clock_hz() / 1e6,
         sms=torch.cuda.get_device_properties(0).multi_processor_count,
         python=sys.version.split()[0],
         torch=torch.__version__, cuda=torch.version.cuda,
         device=torch.cuda.get_device_name(0),
         device_count=torch.cuda.device_count(),
         cudnn_allow_tf32=torch.backends.cudnn.allow_tf32,
         matmul_allow_tf32=torch.backends.cuda.matmul.allow_tf32)
    return smi


def sm_clock_hz():
    return float(nvidia_smi("clocks.max.sm", units=False)) * 1e6


def kernel_key(symbol):
    """``warp<R>`` or ``strip`` for a dtw kernel's mangled name, else None."""
    rows = re.search(r"dtw_warp_kernelILi(\d+)E", symbol)
    if rows:
        return "warp" + rows.group(1)
    return "strip" if "dtw_strip_kernel" in symbol else None


def ptxas_by_kernel(log):
    """Registers, spills and static shared memory of each kernel instance,
    from nvcc's ``-Xptxas -v`` output."""
    out = {}
    name = None
    for line in log.splitlines():
        entry = re.search(r"Compiling entry function '(\S+)'", line)
        if entry:
            name = kernel_key(entry.group(1))
            continue
        if name is None:
            continue
        spill = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads",
                          line)
        if spill:
            out.setdefault(name, {}).update(
                spill_stores=int(spill.group(1)),
                spill_loads=int(spill.group(2)))
        used = re.search(r"Used (\d+) registers", line)
        if used:
            smem = re.search(r"(\d+) bytes smem", line)
            out.setdefault(name, {}).update(
                registers=int(used.group(1)),
                smem_bytes=int(smem.group(1)) if smem else 0)
    return out


def first_loop(instrs):
    """The body of the first backward branch in [(address, opcode,
    instruction)]: a kernel's inner loop."""
    for addr, op, text in instrs:
        target = re.search(r"BRA (0x[0-9a-f]+)", text)
        if op == "BRA" and target and int(target.group(1), 16) < addr:
            start = int(target.group(1), 16)
            return [i for i in instrs if start <= i[0] <= addr]
    return []


def sass_fp32_per_cell():
    """FP32 instructions per DTW cell in each kernel of the built library,
    read from its SASS (``cuobjdump -sass``): FADD + FMUL + FFMA + FMNMX
    over FMNMX / 2, since a cell takes exactly two mins.  Also the inner
    loop's instructions per warp step: the body of the first backward
    branch, over its steps (its FMNMX / 2R).  Keys: ``warp<R>`` (n <= 256,
    R rows a lane) and ``strip`` (n > 256, R = 8)."""
    from deepards_tpu_torch.ops import build

    sass = subprocess.run(
        [build.cuda_tool("cuobjdump"), "-sass",
         str(build.library_path("dtw"))],
        capture_output=True, text=True, check=True, timeout=120).stdout
    code = {}  # kernel -> [(address, opcode, instruction)]
    name = None
    for line in sass.splitlines():
        fn = re.search(r"Function : (\S+)", line)
        if fn:
            name = kernel_key(fn.group(1))
            if name:
                code[name] = []
            continue
        ins = re.match(r"\s*/\*([0-9a-f]+)\*/\s+((?:@!?U?P\w+\s+)?"
                       r"([A-Z][A-Z0-9]*)[^;]*);", line)
        if ins and name:
            code[name].append((int(ins.group(1), 16), ins.group(3),
                               ins.group(2)))
    out = {}
    for name, instrs in code.items():
        count = Counter(op for _, op, _ in instrs)
        fp32 = {k: count[k] for k in ("FADD", "FMUL", "FFMA", "FMNMX")
                if count[k]}
        rows = 8 if name == "strip" else int(name[4:])
        loop = first_loop(instrs)
        loop_steps = sum(op == "FMNMX" for _, op, _ in loop) / (2 * rows)
        out[name] = {
            "fp32_per_cell": sum(fp32.values()) / (count["FMNMX"] / 2),
            "fp32": fp32, "instructions": len(instrs),
            "loop_instructions_per_step": (len(loop) / loop_steps
                                           if loop_steps else None),
            "loop_shuffles_per_step": (
                sum(op == "SHFL" for _, op, _ in loop) / loop_steps
                if loop_steps else None)}
    if set(out) != {"warp{}".format(r) for r in range(1, 9)} | {"strip"}:
        raise AssertionError("dtw kernels missing from the SASS: {}".format(
            sorted(out)))
    return out


def dtw_bound(la, lb, n, per_cell, sms, clock_hz):
    """Least time for one dtw call: input read once and output written
    once at the HBM rate, against the cells' FP32 instructions at the
    SMs' issue rate (``per_cell`` from the SASS)."""
    bsz = la.numel()
    cells = float((la.double() * lb.double()).sum())
    bytes_moved = 2 * bsz * n * 4 + 2 * bsz * 4 + bsz * 4
    bytes_ms = bytes_moved / HBM_BYTES_PER_S * 1e3
    ops_ms = cells * per_cell / (sms * SM_FP32_LANES * clock_hz) * 1e3
    return {"cells": cells, "bytes_ms": bytes_ms, "ops_ms": ops_ms,
            "bound_ms": max(bytes_ms, ops_ms),
            "bound_by": "bytes" if bytes_ms > ops_ms else "operations",
            "bound_ms_5_ops_at_67_tflops": max(
                bytes_ms,
                cells * DTW_OPS_PER_CELL_FLOPS / F32_OPS_PER_S * 1e3)}


def served_chunk(rng):
    """The dtw launch of the main path, built as per_breath_dtw_scores
    builds it for 37 served windows: 740 breaths of 224 give 3 x 737 =
    2,211 pairs, padded to (4096, 256) with pad rows of length 1."""
    from deepards_tpu_torch.dtw.lib import _pad_pairs

    breaths = list(make_windows(rng, 37).reshape(-1, C * L))
    pairs_a = [breaths[i] for i in range(3, len(breaths)) for _ in range(3)]
    pairs_b = [breaths[i - k] for i in range(3, len(breaths))
               for k in (1, 2, 3)]
    return _pad_pairs(pairs_a, pairs_b)


def phase_build():
    from deepards_tpu_torch.ops import build

    t0 = time.perf_counter()
    logs = build.build_all()
    seconds = time.perf_counter() - t0
    ptxas = {name: ptxas_by_kernel(log) for name, log in logs.items()}
    emit("build", seconds=seconds, built=sorted(logs), ptxas=ptxas,
         flags=" ".join(build.NVCC_FLAGS))


def phase_kernel():
    """dtw_cuda against dtw_reference on the card at six shapes, exact,
    then timings beside the bound."""
    import torch

    from deepards_tpu_torch.ops.dtw import (
        dtw_cuda,
        dtw_numpy,
        dtw_reference,
        dtw_resident_warps,
    )
    from deepards_tpu_torch.ops.dtw_timing import device_ms, make_pairs

    rng = np.random.default_rng(SEED)
    dev = torch.device("cuda")
    per_cell = sass_fp32_per_cell()
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    clock_hz = sm_clock_hz()

    def on_card(*arrays):
        return [torch.from_numpy(x).to(dev) for x in arrays]

    # (label, arrays): the main path's launch, per-breath, whole-window and
    # small ragged shapes, a width above 11,622 (too wide for a block to
    # hold 5 n floats; here two strip passes), and the throughput shape
    cases = [("served chunk", served_chunk(rng))]
    cases += [("B {} n {}".format(bsz, n), make_pairs(rng, bsz, n, lo, hi))
              for bsz, n, lo, hi in ((8192, 256, 150, 224),
                                     (256, 4480, 2240, 4480),
                                     (300, 97, 1, 97),
                                     (4, 12288, 9000, 12288),
                                     (65536, 224, 224, 224))]
    shapes = []
    max_err = 0.0
    for label, arrays in cases:
        a, b, la, lb = on_card(*arrays)
        bsz, n = a.shape
        got = dtw_cuda(a, b, la, lb)
        plain_ms = None
        if bsz == 65536:
            plain_ms = cuda_ms(lambda: dtw_reference(a, b, la, lb),
                               warmup=0, reps=10)
        want = dtw_reference(a, b, la, lb)
        torch.cuda.synchronize()
        err = float((got - want).abs().max())
        if not torch.isfinite(got).all() or err != 0.0:
            raise AssertionError(
                "dtw_cuda != dtw_reference at {}: max abs {}".format(
                    label, err))
        for _ in range(5):  # repeatable: no race in the strip hand-off
            if not torch.equal(dtw_cuda(a, b, la, lb), got):
                raise AssertionError("dtw_cuda repeats differ at " + label)
        max_err = max(max_err, err)
        ms = cuda_ms(lambda: dtw_cuda(a, b, la, lb), warmup=2, reps=20)
        # the kernel alone: a call's events also hold the wrapper's host
        # time (tens of microseconds) where the kernel is shorter than that
        kernel_ms = device_ms(lambda: dtw_cuda(a, b, la, lb))
        kernel = "warp{}".format(-(-n // 32)) if n <= 256 else "strip"
        bound = dtw_bound(la, lb, n, per_cell[kernel]["fp32_per_cell"], sms,
                          clock_hz)
        shapes.append({"shape": label, "B": bsz, "n": n,
                       "lengths": [int(la.min()), int(la.max())],
                       "kernel": kernel, "max_abs_err": err, "ms": ms,
                       "device_ms": kernel_ms, "plain_ms": plain_ms,
                       "pairs_per_s": bsz / ms * 1e3,
                       "share_of_bound": bound["bound_ms"] / kernel_ms,
                       **bound})
        print("dtw {}: {} ms per call, {} ms on the device, bound {} ms ({}),"
              " share_of_bound {}".format(
                  label, ms, kernel_ms, bound["bound_ms"], bound["bound_by"],
                  bound["bound_ms"] / kernel_ms), flush=True)

    a, b, la, lb = make_pairs(rng, 8, 224, 150, 224)
    got = dtw_cuda(*on_card(a, b, la, lb)).cpu().numpy()
    oracle = np.array([dtw_numpy(a[i, :la[i]], b[i, :lb[i]])
                       for i in range(8)])
    oracle_rel = float(np.max(np.abs(got - oracle) / np.abs(oracle)))
    if oracle_rel > 1e-4:
        raise AssertionError("dtw_cuda vs f64 oracle rel {}".format(
            oracle_rel))

    resident = {"warp{}".format(r): dtw_resident_warps(32 * r)
                for r in range(1, 9)}
    resident.update({"strip n={}".format(w): dtw_resident_warps(w)
                     for w in (4480, 12288)})
    emit("kernel", shapes=shapes, oracle_max_rel=oracle_rel,
         sass=per_cell, sms=sms, sm_clock_hz=clock_hz,
         resident_warps_per_sm=resident,
         tolerance="exact vs dtw_reference; rtol 1e-4 vs f64 oracle")
    return {**shapes[-1], "max_abs_err": max_err,
            "strip_fp32_per_cell": per_cell["strip"]["fp32_per_cell"]}


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
    try:
        responses = [
            (1, None, post(url, json.dumps({"data": windows[:1].tolist()})
                           .encode(), "application/json")),
            (16, None, post(url, npz(data=windows[:16]),
                            "application/octet-stream")),
            (37, patients, post(url, npz(data=windows, patients=patients),
                                "application/octet-stream")),
        ]
        repeat = post(url, npz(data=windows, patients=patients),
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


TRAIN_EPOCHS = 2  # config 1 trains 10
# card vs CPU after 3 steps from the same params and batches, TF32 off.
# In float32 every tensor but the first conv's kernel is held to 1e-5.
# That kernel's gradient is a sum that cancels (the norm after it makes it
# scale-free): float32 misses it by a few 1e-3 against float64, so two
# float32 summation orders put some elements on opposite sides of the
# 0.01 clamp, and its float32 params after 3 steps are only reported.  It
# is held instead by (a) its float32 gradient on the card against the
# CPU's float64 one at the check's batches, within 2e-2: above the CPU's
# own float32 reading (``first_conv_grad_err``) and below what a zero
# gradient or another batch's gradient would give
# (``first_conv_grad_controls``, which the script requires to exceed the
# limit), and (b) the same 3 steps in float64, where every tensor, that
# kernel included, must agree to 1e-5.
TRAIN_STEP_ATOL = dict(loss=1e-4, params=1e-5, first_conv_grad=2e-2)
FIRST_CONV = "breath_block.conv0.weight"
TRAIN_SERVE_ATOL = 1e-5  # the same params and batch on one device
MEASURE_WINDOWS = 4096  # the device-cache epoch timed: 256 steps of 16


class CacheView:
    """The part of a dataset the trainer's device-cache epoch reads: a
    window cache and its current indices (all of them)."""

    def __init__(self, cache):
        self.cache = cache

    def current_indices(self):
        return np.arange(len(self.cache), dtype=np.int64)


def train_config1(workdir, device):
    """Config 1 through ``deepards_tpu_torch.cli.train.main`` on a seeded
    synthetic cohort, with its checkpoints and results checked."""
    from deepards_tpu_torch.cli.train import main as train_main
    from deepards_tpu_torch.data.dataset import ARDSRawDataset
    from deepards_tpu_torch.data.synthetic import generate_cohort
    from deepards_tpu_torch.train import checkpoint as ckpt

    cohort_dir = os.path.join(workdir, "cohort")
    results_dir = os.path.join(workdir, "results")
    models_dir = os.path.join(workdir, "models")
    cohort = generate_cohort(cohort_dir, n_patients=10,
                             n_breaths_per_patient=400, seed=SEED)
    windows = len(ARDSRawDataset(cohort_dir, 1, cohort, S,
                                 "unpadded_centered_sequences", kfold_num=0,
                                 total_kfolds=5).cache)
    t0 = time.perf_counter()
    trainer = train_main(CONFIG1_FLAGS + [
        "--epochs", str(TRAIN_EPOCHS), "--data-path", cohort_dir,
        "--cohort-file", cohort, "--results-dir", results_dir,
        "--save-model", "config1.pt", "--saved-models-dir", models_dir,
        "--device", device])
    seconds = time.perf_counter() - t0
    res = trainer.results
    folds = {}
    for fold in range(5):
        losses = res.get_meter("loss", fold).values
        aucs = res.reporting.meters.get("test_auc_fold_{}".format(fold))
        rows = [r for r in res.results if r["fold_num"] == fold]
        path = os.path.join(models_dir, "config1-fold{}".format(fold))
        if not losses or not np.isfinite(losses).all():
            raise AssertionError("fold {}: losses {}".format(fold, losses))
        if aucs is None or len(aucs) != TRAIN_EPOCHS or not rows:
            raise AssertionError("fold {}: no AUC meter or patient rows"
                                 .format(fold))
        if ckpt.load_scaling(path) is None or "opt_state" not in \
                ckpt.restore(path):
            raise AssertionError("fold {}: checkpoint or its scaling "
                                 "sidecar missing".format(fold))
        folds[fold] = {"steps": len(losses), "last_loss": losses[-1],
                       "auc": aucs.values, "patients": len(rows)}
    names = os.listdir(results_dir)
    for part in ("_patient_results.json", "_aggregate_results.json",
                 "_maximal_results.json"):
        if not any(n.endswith(part) for n in names):
            raise AssertionError("results file *{} missing".format(part))
    if not any(n.startswith("meters_") for n in names) or not any(
            "_results_" in n for n in names):
        raise AssertionError("meters or results record missing")
    reduced = {"epochs": "10 -> {}".format(TRAIN_EPOCHS),
               "cohort": "synthetic, 10 patients x 400 breaths ({} windows "
                         "of (20, 1, 224)) in place of ~100 patients x "
                         "24 h".format(windows)}
    print("reduced: " + json.dumps(reduced), flush=True)
    return trainer, models_dir, {
        "seconds": seconds, "windows": windows, "folds": folds,
        "results_files": sorted(names), "reduced": reduced,
        "compute_dtype": trainer.conf.get("compute_dtype")}


def train_card_vs_cpu(device):
    """Three steps of full-width cnn_linear/densenet18 at batch 16,
    dropout off, on the device and on the CPU from the same params and
    batches, in float32 and in float64: losses and params must agree
    (``TRAIN_STEP_ATOL``); and the first conv's float32 gradient against
    float64."""
    import torch

    from deepards_tpu_torch.data.pipeline import transform_batch
    from deepards_tpu_torch.models.layers import bn_row_mask
    from deepards_tpu_torch.models.registry import (
        get_base_network,
        get_network_spec,
    )
    from deepards_tpu_torch.train.losses import bce_with_logits
    from deepards_tpu_torch.train.steps import (
        TrainState,
        make_optimizer,
        make_train_step,
    )

    rng = np.random.default_rng(SEED + 2)
    raw = make_windows(rng, 3 * BATCH)
    mu = np.float32([raw.mean()])
    std = np.float32([raw.std()])
    targets = np.eye(2, dtype=np.float32)[rng.integers(0, 2, 3 * BATCH)]
    mask = np.ones(BATCH, np.float32)
    mask[-1] = 0.0  # one pad row
    conf = {"base_network": "densenet18", "network": "cnn_linear"}
    init = get_network_spec("cnn_linear").build(
        conf, get_base_network(conf), S).reset_parameters(
            torch.Generator().manual_seed(SEED)).state_dict()

    def build(dev, dtype):
        model = get_network_spec("cnn_linear").build(
            conf, get_base_network(conf), S)
        model.load_state_dict(init)
        return model.to(device=dev, dtype=dtype)

    def on(dev, dtype, *arrays):
        return [torch.from_numpy(x).to(device=dev, dtype=dtype)
                for x in arrays]

    def batch(k, dev, dtype):
        sl = slice(k * BATCH, (k + 1) * BATCH)
        return on(dev, dtype, raw[sl], targets[sl], mask)

    def run(dev, dtype):
        """Losses, params and the first conv's clamped gradient of each
        step (the optimizer clamps the grads in place)."""
        model = build(dev, dtype)
        state = TrainState(model, make_optimizer(
            model.parameters(), "sgd", learning_rate=0.001,
            weight_decay=0.0001, clip_grad=True, clip_val=0.01),
            torch.Generator(device=dev))
        mu_d, std_d = on(dev, dtype, mu, std)
        step, _ = make_train_step(
            bce_with_logits,
            transform=lambda d: transform_batch(d, mu_d, std_d),
            dropout_active=False)
        losses, clamped = [], []
        conv = dict(model.named_parameters())[FIRST_CONV]
        for k in range(3):
            losses.append(float(step(state, *batch(k, dev, dtype))))
            clamped.append(conv.grad.double().cpu())
        return losses, {k: v.double().cpu()
                        for k, v in model.state_dict().items()}, clamped

    def first_conv_grad(dev, dtype, k):
        """The first conv's gradient (before the clamp) at the init."""
        model = build(dev, dtype)
        data, target, w = batch(k, dev, dtype)
        mu_d, std_d = on(dev, dtype, mu, std)
        with bn_row_mask(w.repeat_interleave(S)):
            out = model(transform_batch(data, mu_d, std_d), True)
        bce_with_logits(out, target, w).backward()
        return dict(model.named_parameters())[FIRST_CONV].grad.double().cpu()

    exact = [first_conv_grad("cpu", torch.float64, k) for k in range(3)]
    grad_err = {
        side: [float((first_conv_grad(dev, torch.float32, k)
                      - exact[k]).abs().max()) for k in range(3)]
        for side, dev in (("cpu", "cpu"), ("device", device))}
    controls = {
        "zero_gradient": [float(g.abs().max()) for g in exact],
        "next_batch": [float((exact[k] - exact[(k + 1) % 3]).abs().max())
                       for k in range(3)]}
    if min(min(v) for v in controls.values()) <= \
            TRAIN_STEP_ATOL["first_conv_grad"]:
        raise AssertionError("the first conv's gradient limit would pass a "
                             "zero or a wrong gradient: {}".format(controls))
    fields = {"atol": TRAIN_STEP_ATOL, "first_conv_grad_err": grad_err,
              "first_conv_grad_controls": controls}
    failed = []
    if max(grad_err["device"]) > TRAIN_STEP_ATOL["first_conv_grad"]:
        failed.append("first conv gradient vs float64 {}".format(
            grad_err["device"]))
    for name, dtype in (("float32", torch.float32),
                        ("float64", torch.float64)):
        cpu_losses, cpu_params, cpu_clamped = run("cpu", dtype)
        dev_losses, dev_params, dev_clamped = run(device, dtype)
        loss_err = float(np.max(np.abs(np.subtract(dev_losses, cpu_losses))))
        errs = {k: float((dev_params[k] - cpu_params[k]).abs().max())
                for k in cpu_params}
        held = dict(errs)
        if dtype == torch.float32:
            held.pop(FIRST_CONV)
        worst = max(held, key=held.get)
        # what a card that left the kernel unchanged would miss by
        moved = float((cpu_params[FIRST_CONV]
                       - init[FIRST_CONV].double()).abs().max())
        if dtype == torch.float64 and moved <= TRAIN_STEP_ATOL["params"]:
            raise AssertionError("3 steps move the first conv by {}: the "
                                 "float64 check could not fail".format(moved))
        fields[name] = {
            "losses_device": dev_losses, "losses_cpu": cpu_losses,
            "max_abs_loss": loss_err, "max_abs_params": held[worst],
            "max_abs_params_at": worst,
            "max_abs_first_conv": errs[FIRST_CONV],
            "first_conv_moved_max_abs": moved,
            "first_conv_clamped_grad_max_abs_by_step": [
                float((d - c).abs().max())
                for d, c in zip(dev_clamped, cpu_clamped)]}
        if (loss_err > TRAIN_STEP_ATOL["loss"]
                or held[worst] > TRAIN_STEP_ATOL["params"]):
            failed.append("{}: loss {}, {} {}".format(
                name, loss_err, worst, held[worst]))
    if failed:
        raise AssertionError("card vs CPU after 3 steps: " + "; ".join(failed))
    return fields


def train_to_serve(trainer, models_dir, device):
    """The last fold's checkpoint served: one /predict over HTTP, and its
    deterministic logits against the trainer's final model on the same
    normalized batch."""
    import torch

    from deepards_tpu_torch.cli.serve import InferenceEngine, serve
    from deepards_tpu_torch.train import checkpoint as ckpt

    path = os.path.join(models_dir, "config1-fold4")
    model = trainer.final_state.model
    engine = InferenceEngine(path, n_sub_batches=S, batch_size=BATCH,
                             scaling=ckpt.load_scaling(path),
                             bn_scope=model.bn_scope, device=device)
    engine.warm()
    windows = make_windows(np.random.default_rng(SEED + 4), BATCH)
    server = serve(engine, "127.0.0.1", 0)
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    try:
        resp = post("http://127.0.0.1:{}/predict".format(
            server.server_address[1]), npz(data=windows),
            "application/octet-stream")
    finally:
        server.shutdown()
        server.server_close()
        thread.join(timeout=30)
    if thread.is_alive():
        raise RuntimeError("server thread did not stop")
    probs = np.stack([resp["prob_other"], resp["prob_ards"]], axis=1)
    if probs.shape != (BATCH, 2) or not np.isfinite(probs).all():
        raise AssertionError("bad served probabilities")
    x = torch.from_numpy(windows).to(engine.device)
    x = (x - engine._mu) / engine._std
    with torch.no_grad():
        got = engine.model(x, True)
        want = model(x, True)
    err = float((got - want).abs().max())
    if err > TRAIN_SERVE_ATOL:
        raise AssertionError("served logits differ from the trainer's "
                             "model by {}".format(err))
    return {"checkpoint": os.path.basename(path), "max_abs_logit": err,
            "atol": TRAIN_SERVE_ATOL, "bn_scope": model.bn_scope}


def random_cache(rng, n):
    """A dataset stand-in over ``n`` random windows of config 1's shape."""
    from deepards_tpu_torch.data.windowing import WindowCache

    return CacheView(WindowCache(
        data=rng.normal(size=(n, S, C, L)).astype(np.float32),
        target=np.eye(2, dtype=np.float32)[rng.integers(0, 2, n)],
        hours=np.zeros((n, S), np.float32),
        patient_idx=np.zeros(n, np.int32), patients=["synthetic"]))


def config1_fold(workdir, device, graphs, ds, dropout=True, *flags):
    """A ``Trainer`` of config 1's flags (and ``flags``) with fold 0's
    state built without a cohort, and a ``StepRunner`` of its steps over
    unit scaling for batches of ``ds``: CUDA-graph replays with
    ``graphs`` (the trainer's own choice on the card), else eager."""
    import torch

    from deepards_tpu_torch.cli.train import build_parser
    from deepards_tpu_torch.config.config import Configuration
    from deepards_tpu_torch.data.pipeline import transform_batch
    from deepards_tpu_torch.train.loop import Trainer
    from deepards_tpu_torch.train.steps import StepRunner, make_train_step

    conf = Configuration(build_parser().parse_args(CONFIG1_FLAGS + [
        "--device", device,
        "--results-dir", os.path.join(workdir, "measure")] + list(flags)))
    trainer = Trainer(conf, verbose=False)
    trainer.n_sub_batches = S
    state = trainer.new_state(0)
    zero = torch.zeros(1, device=trainer.device)
    one = torch.ones(1, device=trainer.device)
    train_step, eval_step = make_train_step(
        trainer.loss_fn, transform=lambda d: transform_batch(d, zero, one),
        compute_dtype=trainer.compute_dtype, dropout_active=dropout)
    runner = StepRunner(state, train_step, eval_step,
                        (BATCH,) + ds.cache.data.shape[1:],
                        graphed=graphs and trainer.device.type == "cuda")
    return trainer, runner


def train_numbers(workdir, device):
    """Step times, profile, memory and epoch rate of config 1's step (full
    width, batch 16, bf16, dropout on) on the device-cache path, over a
    cache of random windows built directly: the steps run eagerly
    (``eager``) and as CUDA-graph replays (``graphed``).  A step is the
    runner's train call over a batch already in its buffers; the epoch
    also gathers each batch on the card.  The build time and the peak
    memory cover the fold's state and the runner (the graphed one's
    warm-up, captures and pools)."""
    import torch

    ds = random_cache(np.random.default_rng(SEED + 3), MEASURE_WINDOWS)
    n = MEASURE_WINDOWS
    out = {}
    for name, graphs in (("eager", False), ("graphed", True)):
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        baseline = torch.cuda.memory_allocated()
        t0 = time.perf_counter()
        trainer, runner = config1_fold(workdir, device, graphs, ds)
        torch.cuda.synchronize()
        build_seconds = time.perf_counter() - t0
        dev = trainer._get_device_cache(ds)
        ids = torch.arange(BATCH, device=trainer.device)
        for key, table in dev.items():
            torch.index_select(table, 0, ids, out=runner.inputs[key])
        runner.inputs["mask"].fill_(1.0)
        train_ms = cuda_ms(runner.train, warmup=3, reps=20)
        eval_ms = cuda_ms(runner.eval, warmup=3, reps=20)
        # 20 steps queued back to back: the step-to-step time, which
        # the device bounds once the host queues faster than it runs
        train_b2b_ms = cuda_ms(lambda: [runner.train() for _ in range(20)],
                               warmup=1, reps=3) / 20
        eval_b2b_ms = cuda_ms(lambda: [runner.eval() for _ in range(20)],
                              warmup=1, reps=3) / 20
        train_profile = device_breakdown(runner.train)
        eval_profile = device_breakdown(runner.eval)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        trainer.run_train_epoch(runner, ds, 0, 1)
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        losses = trainer.results.get_meter("loss", 0).values
        if len(losses) != n // BATCH or not np.isfinite(losses).all():
            raise AssertionError("{} device-cache epoch: {} losses".format(
                name, len(losses)))
        out[name] = {
            "train_step_ms": train_ms, "eval_step_ms": eval_ms,
            "train_back_to_back_ms": train_b2b_ms,
            "eval_back_to_back_ms": eval_b2b_ms,
            "device_ms_per_step": train_profile["device_ms_per_call"],
            "launches_per_step": train_profile["kernel_launches_per_call"],
            "host_dispatches_per_step":
                train_profile["host_dispatches_per_call"],
            "device_idle_share": 1.0 - train_profile["device_ms_per_call"]
            / train_ms,
            "train_profile_top": train_profile["top"],
            "eval_device_ms_per_step": eval_profile["device_ms_per_call"],
            "eval_launches_per_step":
                eval_profile["kernel_launches_per_call"],
            "eval_host_dispatches_per_step":
                eval_profile["host_dispatches_per_call"],
            "eval_device_idle_share": 1.0 - eval_profile["device_ms_per_call"]
            / eval_ms,
            "eval_profile_top": eval_profile["top"],
            "peak_memory_bytes": torch.cuda.max_memory_allocated(),
            "memory_allocated_before_bytes": baseline,
            "runner_build_seconds": build_seconds,
            "epoch_windows": n, "epoch_seconds": seconds,
            "windows_per_s": n / seconds,
            "epoch_ms_per_step": seconds * 1e3 / (n // BATCH),
        }
        print("numbers {}: {} ms a step, {} ms on the device, idle {}, "
              "{} windows/s".format(
                  name, train_ms, out[name]["device_ms_per_step"],
                  out[name]["device_idle_share"], n / seconds), flush=True)
        del runner, trainer
    out["compute_dtype"] = "bfloat16"
    return out


GRAPH_STEPS = 8  # graph_vs_eager: device-cache steps from one fold state
GRAPH_ATOL = 1e-6


def phase_graph_vs_eager(workdir, device="cuda"):
    """GRAPH_STEPS device-cache steps of config 1 from one fold state,
    replayed as CUDA graphs and run eagerly, with cuDNN's deterministic
    algorithms (its default backward sums in another order from run to
    run), then an eval epoch over the same windows: float32 with dropout
    off, losses, every param and the eval logits within GRAPH_ATOL;
    bfloat16 with dropout on, losses and eval logits within GRAPH_ATOL and
    the dropout generator in the same state after the steps."""
    import torch

    from deepards_tpu_torch.train.loop import _epoch_order

    rng = np.random.default_rng(SEED + 6)
    ds = random_cache(rng, GRAPH_STEPS * BATCH)
    ds.cache.data[:] = make_windows(rng, GRAPH_STEPS * BATCH)
    ids, masks = _epoch_order(rng.permutation(GRAPH_STEPS * BATCH), BATCH)
    masks[-1, -3:] = 0.0  # pad rows in the last batch
    deterministic = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    fields = {"steps": GRAPH_STEPS, "atol": GRAPH_ATOL}
    failed = []
    try:
        for dtype, dropout in (("float32", False), ("bfloat16", True)):
            runs = {}
            for graphs in (False, True):
                trainer, runner = config1_fold(
                    workdir, device, graphs, ds, dropout,
                    "--compute-dtype", dtype)
                state = runner.state
                losses, _ = trainer._device_steps(runner, ds, ids, masks,
                                                  True)
                # then an eval epoch over the same windows (dropout as in
                # training)
                _, logits = trainer._device_steps(runner, ds, ids, masks,
                                                  False)
                runs[graphs] = (
                    losses.cpu(),
                    {k: v.detach().cpu()
                     for k, v in state.model.state_dict().items()},
                    state.generator.get_state(), state.step, logits.cpu())
            e_loss, e_params, e_rng, e_step, e_out = runs[False]
            g_loss, g_params, g_rng, g_step, g_out = runs[True]
            loss_err = float((g_loss - e_loss).abs().max())
            param_err = max(float((g_params[k] - e_params[k]).abs().max())
                            for k in e_params)
            logit_err = float((g_out - e_out).abs().max())
            same_rng = bool(torch.equal(g_rng, e_rng))
            fields[dtype] = {
                "dropout": dropout, "losses_graphed": g_loss.tolist(),
                "losses_eager": e_loss.tolist(), "max_abs_loss": loss_err,
                "max_abs_params": param_err, "max_abs_eval_logits":
                logit_err, "generator_state_equal": same_rng,
                "steps": [e_step, g_step]}
            if loss_err > GRAPH_ATOL or logit_err > GRAPH_ATOL or (
                    not dropout and param_err > GRAPH_ATOL):
                failed.append("{}: loss {}, params {}, eval logits {}"
                              .format(dtype, loss_err, param_err,
                                      logit_err))
            if dropout and not same_rng:
                failed.append("{}: generator states differ".format(dtype))
            if e_step != g_step or not torch.isfinite(g_loss).all():
                failed.append("{}: steps {} / {}".format(dtype, e_step,
                                                          g_step))
    finally:
        torch.backends.cudnn.deterministic = deterministic
    emit("graph_vs_eager", **fields)
    if failed:
        raise AssertionError("graphed vs eager: " + "; ".join(failed))


# the rest of config 1's trainer through the CLI
SURFACE_FLAGS = ["--transforms", "ie_ww", "--fused-steps", "4",
                 "--butter-low", "0.5", "--checkpoint-every-n-steps", "2"]
SURFACE_RESUME_FROM = "surface-epoch1-fold0-step4"
PREDICT_ATOL = 1e-5  # predict vs the trainer's eval of one checkpoint


def phase_config1_surface(workdir, device="cuda"):
    """Config 1's flags with SURFACE_FLAGS through the CLI on a synthetic
    cohort (fold 0, 2 epochs, cuDNN's deterministic algorithms); a resume
    from a step checkpoint must reproduce the run's later losses exactly;
    ``cli.predict`` on the final checkpoint must match the trainer's eval
    of it (``--load-checkpoint --no-train``) within PREDICT_ATOL, with the
    same votes; then one epoch each of the metadata dataset type and of
    ``--with-fft``."""
    import torch

    from deepards_tpu_torch.cli.predict import main as predict_main
    from deepards_tpu_torch.cli.train import main as train_main
    from deepards_tpu_torch.data.synthetic import generate_cohort

    def path(*parts):
        return os.path.join(workdir, *parts)

    cohort = generate_cohort(path("surface_cohort"), n_patients=10,
                             n_breaths_per_patient=1200, seed=SEED + 5)
    base = CONFIG1_FLAGS + [
        "--data-path", path("surface_cohort"), "--cohort-file", cohort,
        "--only-fold", "0", "--epochs", "2", "--device", device
    ] + SURFACE_FLAGS
    deterministic = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    fields = {"flags": SURFACE_FLAGS, "seconds": {}}
    try:
        t0 = time.perf_counter()
        full = train_main(base + [
            "--results-dir", path("surface_results"), "--save-model",
            "surface.pt", "--saved-models-dir", path("surface_models")])
        fields["seconds"]["train"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        resumed = train_main(base + [
            "--results-dir", path("resumed_results"), "--load-checkpoint",
            path("surface_models", SURFACE_RESUME_FROM), "--save-model",
            "resumed.pt", "--saved-models-dir", path("resumed_models")])
        fields["seconds"]["resume"] = time.perf_counter() - t0
        fields["resume"] = compare_resumed(full, resumed)
        fields["predict"] = predict_vs_eval(
            base, path, predict_main, train_main)
        fields["metadata"] = surface_run(train_main, workdir, device, [
            "--dataset-type",
            "padded_breath_by_breath_with_flow_time_features"])
        fields["with_fft"] = surface_run(train_main, workdir, device,
                                         ["--with-fft"])
    finally:
        torch.backends.cudnn.deterministic = deterministic
    emit("config1_surface", **fields)


def compare_resumed(full, resumed):
    """The resumed run's losses against the run's, from the checkpoint on:
    exactly equal, or AssertionError."""
    meters = full.results.reporting.meters
    again = resumed.results.reporting.meters
    next_batch = int(SURFACE_RESUME_FROM.rsplit("step", 1)[1])
    pairs = [(meters["loss_epoch_1_fold_0"].values[next_batch:],
              again["loss_epoch_1_fold_0"].values)]
    pairs += [(meters[k].values, again[k].values)
              for k in ("loss_epoch_2_fold_0", "test_loss_fold_0")]
    for want, got in pairs:
        if len(want) != len(got) or not want:
            raise AssertionError("resumed run: {} losses, the run {}".format(
                len(got), len(want)))
    diff = max(float(np.max(np.abs(np.subtract(got, want))))
               for want, got in pairs)
    steps = [len(meters["loss_epoch_1_fold_0"].values),
             len(meters["loss_epoch_2_fold_0"].values)]
    if diff != 0.0:
        raise AssertionError("resumed losses differ from the run's by "
                             "{}".format(diff))
    return {"from": SURFACE_RESUME_FROM, "train_steps_by_epoch": steps,
            "losses_compared": sum(len(w) for w, _ in pairs),
            "max_abs_loss_diff": diff,
            "final_step": [full.final_state.step, resumed.final_state.step]}


def predict_vs_eval(base, path, predict_main, train_main):
    """cli.predict on the final checkpoint against the trainer's eval of
    the same checkpoint."""
    checkpoint = path("surface_models", "surface-fold0")
    t0 = time.perf_counter()
    rows, votes = predict_main([
        "--checkpoint", checkpoint, "-o", path("predictions.csv"),
        "--votes-output", path("votes.json")] + base)
    seconds = time.perf_counter() - t0
    evaluated = train_main(base + [
        "--results-dir", path("eval_results"), "--load-checkpoint",
        checkpoint, "--no-train", "--epochs", "1"])
    logits = evaluated.last_eval["logits"].astype(np.float64)
    want = np.exp(logits - logits.max(axis=1, keepdims=True))
    want /= want.sum(axis=1, keepdims=True)
    got = np.array([[r["prob_other"], r["prob_ards"]] for r in rows])
    if [r["window_index"] for r in rows] != \
            evaluated.last_eval["index"].tolist():
        raise AssertionError("predict and the eval visit other windows")
    err = float(np.abs(got - want).max())
    records = {r["patient"]: r for r in evaluated.results.results}
    votes_equal = len(records) == len(votes) and all(
        v["pred_frac"] == records[v["patient"]]["pred_frac"]
        and (v["pred_frac"] == 0.5
             or v["prediction"] == records[v["patient"]]["prediction"])
        for v in votes)
    if err > PREDICT_ATOL or not votes_equal or not os.path.exists(
            path("predictions.csv")):
        raise AssertionError("predict vs the trainer's eval: max abs {}, "
                             "votes equal {}".format(err, votes_equal))
    return {"windows": len(rows), "patients": len(votes),
            "max_abs_prob": err, "atol": PREDICT_ATOL,
            "votes_equal": votes_equal, "predict_seconds": seconds}


def surface_run(train_main, workdir, device, flags):
    """One epoch of fold 0 of config 1 with ``flags`` on the small
    cohort of the train phase."""
    cohort_dir = os.path.join(workdir, "cohort")
    cohort = os.path.join(cohort_dir, "cohort-description.csv")
    t0 = time.perf_counter()
    trainer = train_main(CONFIG1_FLAGS + [
        "--data-path", cohort_dir, "--cohort-file", cohort, "--only-fold",
        "0", "--epochs", "1", "--device", device, "--results-dir",
        os.path.join(workdir, "run_" + flags[-1].strip("-"))] + flags)
    losses = trainer.results.get_meter("loss", 0).values
    if not losses or not np.isfinite(losses).all() or not \
            trainer.results.get_meter("test_auc", 0).values:
        raise AssertionError("{}: losses {}".format(flags, losses))
    model = trainer.final_state.model
    return {"flags": flags, "steps": len(losses), "last_loss": losses[-1],
            "input_channels": model.breath_block.conv0.in_channels,
            "head_inputs": model.head.in_features,
            "seconds": time.perf_counter() - t0}


def phase_train(workdir, smi, device="cuda"):
    """Config 1 trained on the device through the CLI, the card held
    against the CPU, a trained checkpoint served, and the step numbers."""
    import torch

    t0 = time.perf_counter()
    trainer, models_dir, run = train_config1(workdir, device)
    fields = {"card": smi, "config1": run,
              "card_vs_cpu": train_card_vs_cpu(device),
              "train_to_serve": train_to_serve(trainer, models_dir, device),
              "cudnn_allow_tf32": torch.backends.cudnn.allow_tf32,
              "matmul_allow_tf32": torch.backends.cuda.matmul.allow_tf32}
    if device == "cuda":
        fields["numbers"] = train_numbers(workdir, device)
    fields["train_phase_seconds"] = time.perf_counter() - t0
    emit("train", **fields)


# the DTW heterogeneity sweep: the reference hetero runner's cohort of 80
# patients (its ``hetero`` defaults: train_n 40, test_n 6), 60 windows each
SIM_PATIENTS, SIM_WINDOWS, SIM_N_RANDOM = 80, 60, 50
SIM_KEEP = 256  # pairs of the sweep's first chunk held to dtw_reference
SUB_PATIENTS, SUB_N_RANDOM = 8, 4  # the sub-cohort held card vs CPU


def cohort_dataset(workdir, data, patho, n_windows):
    """An ``ARDSRawDataset`` over windows ``data`` of len(patho) patients
    ("1", "2", ...) with ``n_windows`` each, patient k of class patho[k]."""
    from deepards_tpu_torch.data.dataset import ARDSRawDataset
    from deepards_tpu_torch.data.windowing import WindowCache

    n_patients = len(patho)
    cohort = os.path.join(workdir, "cohort-{}.csv".format(n_patients))
    with open(cohort, "w") as f:
        f.write("Patient Unique Identifier,Pathophysiology\n")
        f.writelines("{},{}\n".format(k + 1, "ARDS" if y else "OTHER")
                     for k, y in enumerate(patho))
    cache = WindowCache(
        data=data,
        target=np.eye(2, dtype=np.float32)[np.repeat(patho, n_windows)],
        hours=np.tile(np.arange(n_windows * data.shape[1], dtype=np.float32)
                      .reshape(n_windows, -1) * 0.05, (n_patients, 1)),
        patient_idx=np.repeat(np.arange(n_patients), n_windows).astype(
            np.int32),
        patients=[str(k + 1) for k in range(n_patients)])
    return ARDSRawDataset(workdir, 1, cohort, data.shape[1],
                          "unpadded_centered_sequences", cache=cache)


def phase_dtw_similarity(workdir, device="cuda", per_cell=None,
                         n_patients=SIM_PATIENTS, n_windows=SIM_WINDOWS,
                         nb=S, train_n=40, test_n=6):
    """The inter-patient DTW matrix of a seeded cohort (``n_patients`` x
    ``n_windows`` windows of (nb, 1, 224), half of the patients ARDS, each
    patient's flow at its own scale) through ``find_patient_similarity``,
    ``random`` method, 50 window pairs per patient pair raveled to n = nb
    x 224: C(80, 2) x 50 = 158,000 pairs at n = 4480 on the card.  Holds
    the matrix (symmetric, zero diagonal, finite, >= 0), SIM_KEEP pairs of
    the first chunk to dtw_reference on the same device exactly, and a
    sub-cohort's matrix on the device to the CPU's exactly; times the
    sweep's host pad, copy and kernel per chunk, and
    ``generate_hetero_splits`` with the CLI's defaults on the matrix.
    Returns the sweep's kernel launches."""
    import torch

    import deepards_tpu_torch.ops.dtw as dtw_ops
    from deepards_tpu_torch.cli.sim_dissim import generate_hetero_splits
    from deepards_tpu_torch.config import splitfile
    from deepards_tpu_torch.dtw.lib import SweepTimer, find_patient_similarity
    from deepards_tpu_torch.ops.dtw import dtw_reference

    rng = np.random.default_rng(SEED + 7)
    patho = np.arange(n_patients) % 2
    data = make_windows(rng, n_patients * n_windows, nb)
    data *= np.repeat(rng.uniform(0.6, 1.4, n_patients),
                      n_windows)[:, None, None, None].astype(np.float32)
    ds = cohort_dataset(workdir, data, patho, n_windows)
    n = nb * C * L
    pairs = n_patients * (n_patients - 1) // 2 * min(SIM_N_RANDOM, n_windows)

    timer = SweepTimer(keep=SIM_KEEP)
    dtw_ops.launches = 0
    t0 = time.perf_counter()
    mat = find_patient_similarity(ds, dist_method="random",
                                  n_random=SIM_N_RANDOM, device=device,
                                  timer=timer)
    seconds = time.perf_counter() - t0
    launches = dtw_ops.launches
    v = mat.values
    if v.shape != (n_patients, n_patients) or not np.isfinite(v).all() or \
            (v < 0).any() or not (v == v.T).all() or np.diag(v).any() or \
            not (v[~np.eye(n_patients, dtype=bool)] > 0).all():
        raise AssertionError("similarity matrix: not a distance matrix")

    a, b, la, lb, d = timer.kept
    kept_err = float((d - dtw_reference(a, b, la, lb)).abs().max())
    if kept_err != 0.0 or not torch.isfinite(d).all():
        raise AssertionError("{} pairs of the sweep vs dtw_reference: max "
                             "abs {}".format(SIM_KEEP, kept_err))

    sub = cohort_dataset(workdir, data[:SUB_PATIENTS * n_windows],
                         patho[:SUB_PATIENTS], n_windows)
    t1 = time.perf_counter()
    sub_mats = [find_patient_similarity(
        sub, dist_method="random", n_random=SUB_N_RANDOM,
        rng=np.random.default_rng(1), device=dev) for dev in (device, "cpu")]
    sub_seconds = time.perf_counter() - t1
    sub_err = float(np.abs(sub_mats[0].values - sub_mats[1].values).max())
    if sub_err != 0.0 or sub_mats[0].patients != sub_mats[1].patients:
        raise AssertionError("sub-cohort matrix, device vs CPU: max abs "
                             "{}".format(sub_err))

    t1 = time.perf_counter()
    written = generate_hetero_splits(ds, os.path.join(workdir, "splits"),
                                     train_n=train_n, test_n=test_n,
                                     similarity=mat)
    split_seconds = time.perf_counter() - t1
    for path in written:
        split = splitfile.read(path)
        if len(split["train"]) != train_n - train_n % 2 or \
                set(split["train"]) & set(split["test"]) or not split["test"]:
            raise AssertionError("bad split file {}: {}".format(path, split))

    fields = {
        "card": nvidia_smi_line() if device == "cuda" else None,
        "patients": n_patients, "windows_per_patient": n_windows, "n": n,
        "pairs": pairs, "chunks": len(timer.pad_s), "launches": launches,
        "seconds": seconds, "pairs_per_s": pairs / seconds,
        "host_pad_s": sum(timer.pad_s), "copy_s": sum(timer.copy_s),
        "kernel_ms": sum(timer.kernel_ms),
        "per_chunk": {"pad_s": timer.pad_s, "copy_s": timer.copy_s,
                      "kernel_ms": timer.kernel_ms},
        "kept_pairs_vs_reference_max_abs": kept_err,
        "sub_cohort": {"patients": SUB_PATIENTS, "n_random": SUB_N_RANDOM,
                       "max_abs_device_vs_cpu": sub_err,
                       "seconds": sub_seconds},
        "distance_range": [float(v[v > 0].min()), float(v.max())],
        "hetero_splits": {"files": len(written), "train_n": train_n,
                          "test_n": test_n, "seconds": split_seconds},
    }
    if device == "cuda":
        sms = torch.cuda.get_device_properties(0).multi_processor_count
        clock_hz = sm_clock_hz()
        cells = float(pairs) * n * n
        ops_ms = cells * per_cell / (sms * SM_FP32_LANES * clock_hz) * 1e3
        bytes_ms = (2 * pairs * n * 4 + 3 * pairs * 4) / HBM_BYTES_PER_S * 1e3
        kernel_ms = fields["kernel_ms"]
        fields.update(
            cells=cells, bound_ms=max(ops_ms, bytes_ms),
            bound_by="operations" if ops_ms >= bytes_ms else "bytes",
            kernel_share_of_bound=max(ops_ms, bytes_ms) / kernel_ms,
            kernel_pairs_per_s=pairs / kernel_ms * 1e3,
            other_host_s=seconds - fields["host_pad_s"] - fields["copy_s"]
            - kernel_ms / 1e3)
        if launches == 0:
            raise AssertionError("the similarity sweep launched no kernel")
    print("dtw_similarity: {} pairs at n = {} in {} s: pad {} s, copy {} s, "
          "kernel {} ms".format(pairs, n, seconds, fields["host_pad_s"],
                                fields["copy_s"], fields["kernel_ms"]),
          flush=True)
    emit("dtw_similarity", **fields)
    return launches


# the generated experiment train_sim_test_sim_dissim_split_1.yml
# (deepards_tpu/config/experiment_files/generated/) as flags, epochs cut
HETERO_TRAIN_FLAGS = [
    "--base-network", "densenet18", "--batch-size", "16", "--clip-val",
    "0.01", "--dataset-type", "unpadded_centered_sequences", "--network",
    "cnn_linear", "--holdout-set-type", "train_sim_test_sim_dissim_split_1",
    "--final-validation", "--epochs", "1"]


def phase_hetero(workdir, device="cuda", nb=S, n_patients=16,
                 n_breaths=600, train_n=6, test_n=4):
    """The heterogeneity study as a user runs it, through the CLIs on an
    ETL cohort: ``cli.sim_dissim hetero`` on a saved ``.npz`` dataset,
    ``cli.perform_data_splitting preset_file`` on split 1, a holdout
    ``cli.train`` on it, ``cli.sim_dissim breakdown`` of its results, and
    ``cli.analysis lstm-dtw`` twice, the second from its cache with no
    kernel launch.  Returns the kernel launches of the chain."""
    import deepards_tpu_torch.ops.dtw as dtw_ops
    from deepards_tpu_torch.cli import analysis, perform_data_splitting
    from deepards_tpu_torch.cli import sim_dissim
    from deepards_tpu_torch.cli.train import main as train_main
    from deepards_tpu_torch.config import splitfile
    from deepards_tpu_torch.data.dataset import ARDSRawDataset
    from deepards_tpu_torch.data.synthetic import generate_cohort

    def path(*parts):
        return os.path.join(workdir, *parts)

    data_path = path("hetero_cohort")
    cohort = generate_cohort(data_path, n_patients=n_patients,
                             n_breaths_per_patient=n_breaths, seed=SEED + 8,
                             subdirs=("all_data", "aim1_70_30_training"))
    npz = ARDSRawDataset(data_path, 1, cohort, nb,
                         "unpadded_centered_sequences").save(
                             path("hetero.npz"))
    steps = {}

    def step(name, argv, main):
        before = dtw_ops.launches
        t0 = time.perf_counter()
        out = main(argv)
        steps[name] = {"seconds": time.perf_counter() - t0,
                       "launches": dtw_ops.launches - before}
        return out

    written = step("sim_dissim_hetero", [
        "hetero", "--train-from-pickle", npz, "-o", path("splits"),
        "--n-splits", "3", "--train-n", str(train_n), "--test-n",
        str(test_n), "--device", device], sim_dissim.main)
    split_file = written[0]
    split = splitfile.read(split_file)
    step("perform_data_splitting", [
        "-dp", data_path, "-c", cohort, "preset_file", "-f", split_file],
        perform_data_splitting.main)
    trainer = step("train", HETERO_TRAIN_FLAGS + [
        "--n-sub-batches", str(nb), "--data-path", data_path,
        "--cohort-file", cohort, "--results-dir", path("hetero_results"),
        "--device", device], train_main)
    losses = trainer.results.get_meter("loss", 0).values
    tested = {r["patient"] for r in trainer.results.results}
    if not losses or not np.isfinite(losses).all() or \
            tested != set(split["test"]):
        raise AssertionError("holdout training: losses {}, tested {} of "
                             "{}".format(losses, tested, split["test"]))
    record = [n for n in os.listdir(path("hetero_results"))
              if "_results_" in n]
    frames = step("breakdown", ["breakdown", path("hetero_results",
                                                   record[0]), split_file],
                  sim_dissim.main)
    if set(frames) != {"similar", "dissimilar"} or any(
            r["group"] != kind for kind, rows in frames.items()
            for r in rows):
        raise AssertionError("breakdown: {}".format(frames))
    argv = ["lstm-dtw", "--train-from-pickle", npz, "--cache-dir",
            path("dtw_cache"), "--device", device]
    first = step("lstm_dtw", argv, analysis.main)
    again = step("lstm_dtw_cached", argv, analysis.main)
    if again != first or steps["lstm_dtw_cached"]["launches"]:
        raise AssertionError("the cached lstm-dtw ran the kernel or "
                             "differs: {}".format(steps))
    if device == "cuda" and not (steps["sim_dissim_hetero"]["launches"]
                                 and steps["lstm_dtw"]["launches"]):
        raise AssertionError("the hetero chain launched no kernel: {}"
                             .format(steps))
    emit("hetero", patients=n_patients, n_sub_batches=nb, split=split,
         steps=steps, train_losses=losses,
         breakdown={k: [{c: r[c] for c in ("patho", "accuracy", "auc")}
                        for r in rows] for k, rows in frames.items()},
         fold_mean_dtw=first["fold_mean_dtw"])
    return sum(s["launches"] for s in steps.values())


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

    # the training paths run no hand-written kernel: counts from 0 just
    # before them, read just after
    dtw_ops.launches = 0
    with tempfile.TemporaryDirectory(dir=BUILD_DIR) as work:
        phase_train(work, smi)
        phase_graph_vs_eager(work)
        phase_config1_surface(work)
    emit("train_path_kernel_launches", dtw=dtw_ops.launches)

    # the DTW heterogeneity paths: the sweep's counts from 0 just before
    # it (inside the phase, whose checks launch the kernel too), the CLI
    # chain's just before it, each read just after
    by_path = {"serve": launches}
    with tempfile.TemporaryDirectory(dir=BUILD_DIR) as work:
        by_path["dtw_similarity"] = phase_dtw_similarity(
            work, per_cell=dtw_stats["strip_fp32_per_cell"])
        dtw_ops.launches = 0
        by_path["hetero"] = phase_hetero(work)
        if dtw_ops.launches != by_path["hetero"]:
            raise AssertionError("hetero launches: {} counted, {} by step"
                                 .format(dtw_ops.launches, by_path["hetero"]))

    print(json.dumps({"kernels": [{
        "name": "dtw",
        "route": "cuda",
        "source": "deepards_tpu_torch/ops/csrc/dtw.cu",
        "replaces": "deepards_tpu/ops/dtw.py:119",
        "launches": sum(by_path.values()),
        "launches_by_path": by_path,
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
