#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (deepards_tpu_torch) on one card.

    python3 chip_smoke.py [--phases a,b]

Run from the root of a checkout on a machine with an NVIDIA H100.  With
``--phases`` it runs ``env``, ``build`` and the kernel check, then the
named phases of ``PHASES`` alone (a phase that reads another's
checkpoints asks for it); with none it runs every phase.  It
builds the CUDA kernels from the checkout's sources with nvcc, holds each
kernel against its plain PyTorch version (the DTW kernel exactly, at six
shapes, each timed beside a bound computed from the FP32 instructions per
cell in the kernel's SASS and the card's SM clock; the LSTM kernels within
stated tolerances of the loop at the nested network's shape and cnn_lstm's
with a carry, then timed graphed at the nested shape beside the loop,
cuDNN's ``torch.nn.LSTM`` and the floor of 2 x 2,048 cluster barriers;
every network with an LSTM outside ``vmap`` must launch them, and the
real-size nested step replays both), then drives the port's
main path: a server over a full-width cnn_linear/densenet18 checkpoint (random
weights from a seed) answering /predict requests, and DTW scoring of the
served windows' breaths through the kernel.  Then the training path:
benchmark config 1 trained through ``deepards_tpu_torch.cli.train`` on a
seeded synthetic cohort (5 folds, 2 epochs, every step a CUDA-graph
replay), three steps held against the CPU in float32 and float64, a
trained checkpoint served, and the bf16 step and an epoch (1024 windows
eagerly, 4096 as graph replays) timed.  ``graph_vs_eager`` holds 2 graphed
device-cache steps of config 1 to the same steps run eagerly, and
``config1_surface`` drives the rest of config 1's trainer through the CLI
(augmentation, the Butterworth filter, fused host epochs, step
checkpoints and a resume that must reproduce the run, ``cli.predict``
against the trainer's eval, the metadata input, the FFT channels).
Then benchmark configs 2, 3 and 4 (``config2``: cnn_linear over resnet18
on padded breaths; ``config3``: the breath-metadata regressor, Adam, the
``main`` holdout; ``config4``: cnn_lstm), each trained through the CLI at
full width, 3 float32 steps held against the CPU, 2 graphed steps held to
eager ones, a trained checkpoint served and predicted (configs 2 and 4),
and the bf16 graphed step timed over a 4096-window device cache; no
training path may launch the DTW kernel.
Then the DTW heterogeneity workflow: ``dtw_similarity`` scores the
inter-patient matrix of a seeded 80-patient cohort (158,000 window pairs
at n = 4480 through the kernel), holds pairs of the sweep to
``dtw_reference`` and a sub-cohort to the CPU exactly, times host pad,
copy and kernel, and picks the hetero split files on the matrix;
``hetero`` drives the study's CLIs on an ETL cohort (``cli.sim_dissim
hetero``, ``cli.perform_data_splitting``, a holdout ``cli.train``,
``breakdown`` and a cached ``cli.analysis lstm-dtw``).
The last three training phases: ``config4_unshuffled`` (cnn_lstm's
stateful fold, one window a step with the LSTM carry kept across a
patient's windows), ``config7`` (config 1's five folds trained at once
under ``torch.func.vmap``, each fold's slice of a stacked step held to its
own sequential step, beside and against five sequential steps, also over
resnet18) and ``config5`` (ProtoPNet's three stages and the prototype
push, and GradCAM over 128 sequences), each trained through the CLI, held
against the CPU and graphed against eager, and timed.
Then ``explain`` drives the explain CLIs over config 1's and config 5's
fold-0 checkpoints on a seeded cohort: ``cli.patient_gradcam --ops
dtw_clust`` on a patient of 60 windows (its cam-active spans scored
pairwise through the DTW kernel, the matrix held to ``dtw_reference``
exactly, the cams to the CPU, each stage timed), the CLI's six other ops,
``find_similar_cam_regions`` and ``cli.protopnet_analysis`` (distances
and probabilities held to the CPU, features to their own distances).
Then ``sequence`` takes each of the sequence networks (``SEQUENCE_FLAGS``:
lstm_only, lstm_only_with_packing, double_lstm, cnn_transformer, the
heads cnn_double_linear, cnn_single_breath_linear, cnn_linear_to_mean and
cnn_linear_compr_to_rf, and the nested networks through the nested
trainer) through the CLI (5 folds, 1 epoch), holds 3 full-width steps to
the CPU in float32 and float64 (the median networks take the CPU's sort
picks on the card, and its own sorts are held apart), graphed steps to
eager ones, a
served and a predicted checkpoint to the trainer, a nested patient's
padded logits to its own bucket's, times the bf16 graphed step, and runs
one real-size nested step (a 1,440-window patient in bucket 2,048); it
prints one line a network.  Then ``two_d`` takes each 2D network
(``TWO_D_FLAGS``: cnn_linear_2d, its FFT variant, cnn_linear_2x1d with
kernel 11 and its transforms, protopnet_2d, retinanet_2d) through the CLI
over 224x224 breath images, each step a graph replay on the card, holds 3
full-width steps to the CPU (a ProtoPNet stage 1, and its push), graphed
steps to eager ones and a cnn_linear_2d checkpoint's ``cli.predict`` to
the trainer's eval, and times the bf16 graphed step and a host epoch
with its share in ``gather``; one line a network.  Then ``siamese``
takes each twin network (``SIAMESE_FLAGS``) through the CLI, checks its
triplets (a negative from the anchor's own patient must fail), holds 3
steps to the CPU and graphed steps to eager ones and times the step,
then siamese_pretrained with each time layer from siamese_cnn_linear's
checkpoint, served and predicted against the trainer; ``backbones``
does the same for each new base network under cnn_linear, the
autoencoder and ProtoPNet over vgg11_bn (``BACKBONE_FLAGS``); one line a
network.  Then ``analytics``: config 1 trained through the CLI with
``--perform-dtw-preprocessing`` (the DTW kernel's path inside training;
its patients' frames held exactly to the CPU's, with planted faults), one
real-size patient (1,440 windows) through the same hook, timed by stage
beside the kernel's bound, ``cli.evaluate`` over the train phase's fold
checkpoints against ``cli.predict``, ``cli.cam_analytics`` (one-d, two-d,
butter) card vs CPU over the checkpoints of an FFT run and a Butterworth
run, and ``cli.mean_metrics``, ``cli.visualize_results`` and
``cli.find_all_experiments`` over the phase's results; between the DTW
run and the real-size patient, config 1 again with
``--plot-dtw-with-disease --plot-tiled-disease-evol`` (the last fold): its
DTW frames equal the DTW run's, its kernel launches counted, each PNG
stage refused by name on the card and its ``.npz`` written.  Then
``experiments``, with PyYAML and pandas blocked: configs 1-5's experiment
files through ``-co`` against their flags, ``cli.evaluate -co`` in the
``evaluate_config`` layout, ``cli.registry_sweep`` over 8 generated
configs, a reference-format pickle of a cohort trained through
``--train-from-pickle`` against its ``.npz`` (caches and losses exactly
equal, a shifted hour caught), and ``utils.profiling.trace`` around 3
graphed steps (a CUDA kernel named in the trace).  Then ``distributed``:
config 1 over 2 ranks of ``cli.launch_distributed`` (gloo, both on the
one card, float32, fold 0 x 1 epoch) against one process at
``--dp-devices 2``: the ranks' results equal, an eval-only fold equal
(AUC exact, losses rtol 1e-5), 3 trained steps at batch 15 (padded to 16
and sharded) held as config 1's card-vs-CPU check holds them, 3 float64
steps of 2 ranks against one process, and the ranks' eager step timed
beside the one process's graphed step; no DTW.
The CPU sides of
the card-vs-CPU checks of ``sequence``, ``siamese`` and ``backbones`` run
in a worker process from the start (``CpuSides``), and every run of such
a check replays the CPU float64 run's sort picks and clamp decisions.
Every other phase prints one JSON line, ``cpu_worker`` the worker's busy
and wait seconds, and ``phase_seconds`` each phase's seconds; any
failure exits nonzero (the phases after a failed one still run).  The
last two lines are the card's ``nvidia-smi`` name and power limit and
``{"ok": true, "device": {...}}``.  Without a card it exits 1 and prints
no result.
"""
import contextlib
import copy
import glob
import io
import json
import os
import re
import subprocess
import sys
import tempfile
import threading
import time
import types
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
# benchmark configs 2, 3 and 4 the same way
# (deepards_tpu/config/experiment_files/padded_breath_by_breath_resnet18.yml,
# bm_pretraining_regression.yml, unpadded_centered_nb20_cnn_lstm.yml)
CONFIG2_FLAGS = [
    "--clip-val", "0.01", "--clip-grad",
    "--dataset-type", "padded_breath_by_breath", "--base-network", "resnet18",
    "--oversample-minority", "--kfolds", "5", "--epochs", "10",
    "--batch-size", "16", "--network", "cnn_linear", "--n-sub-batches", "20",
]
CONFIG3_FLAGS = [
    "--dataset-type", "padded_breath_by_breath_with_full_bm_target",
    "--network", "cnn_regressor", "--holdout-set-type", "main",
    "--epochs", "10", "--batch-size", "64", "--n-sub-batches", "1",
    "--optimizer", "adam", "--learning-rate", "0.001",
]
CONFIG4_FLAGS = [
    "--clip-val", "0.01", "--clip-grad",
    "--dataset-type", "unpadded_centered_sequences",
    "--oversample-minority", "--kfolds", "5", "--epochs", "10",
    "--batch-size", "16", "--network", "cnn_lstm", "--n-sub-batches", "20",
    "--time-series-hidden-units", "16",
]
# benchmark config 5 (unpadded_centered_nb20_protopnet.yml: ProtoPNet over
# densenet18, 10 prototypes a class of 128 channels)
CONFIG5_FLAGS = [
    "--dataset-type", "unpadded_centered_sequences", "--network", "protopnet",
    "--kfolds", "5", "--epochs", "10", "--batch-size", "16",
    "--n-sub-batches", "20", "--n-warm-epochs", "3", "-pse", "6",
    "--push-every-n", "6", "--n-push-iters", "5", "--clust-lambda", "0.8",
    "--sep-lambda", "0.2", "-np", "10", "-ic", "-0.5",
]
# the sequence networks (the ``sequence`` phase): lstm_only and
# lstm_only_with_packing as their experiment files
# (deepards_tpu/config/experiment_files/generated/
# lstm_only_experiment_benchmark.yml, lstm_only_with_packing.yml; the
# latter spells epochs "pochs", a key nothing reads, so it trains the
# default 10), the others as config 1 with the network changed
LSTM_ONLY_FLAGS = [
    "--batch-size", "16", "--clip-grad", "--clip-val", "0.01",
    "--dataset-type", "unpadded_centered_sequences", "--epochs", "10",
    "--kfolds", "5", "--n-sub-batches", "20", "--network", "lstm_only",
    "--oversample-minority",
]
LSTM_PACKING_FLAGS = [
    "--batch-size", "16", "--clip-grad", "--clip-val", "0.01",
    "--dataset-type", "padded_breath_by_breath", "--kfolds", "5",
    "--n-sub-batches", "20", "--network", "lstm_only_with_packing",
    "--oversample-minority",
]
LSTM_ONLY = ("lstm_only", "lstm_only_with_packing", "double_lstm")
NESTED_NETWORKS = ("cnn_to_nested_rnn", "cnn_to_nested_lstm",
                   "cnn_to_nested_transformer")
SEQUENCE_FLAGS = {
    "lstm_only": LSTM_ONLY_FLAGS,
    "lstm_only_with_packing": LSTM_PACKING_FLAGS,
    **{name: CONFIG1_FLAGS + ["--network", name]
       for name in ("double_lstm", "cnn_transformer", "cnn_double_linear",
                    "cnn_single_breath_linear", "cnn_linear_to_mean",
                    "cnn_linear_compr_to_rf") + NESTED_NETWORKS},
}
# config 5's schedule cut to pass through every stage and two pushes
CONFIG5_CUT = ["--epochs", "3", "--n-warm-epochs", "1", "-pse", "2",
               "--push-every-n", "1", "--n-push-iters", "1"]
# the 2D networks (the ``two_d`` phase) as their experiment files
# (deepards_tpu/config/experiment_files/generated/
# unpadded_centered_nb20_cnn_linear_2d_bs2.yml, ..._2d_bs2_fft_baseline.yml,
# ..._2x1d_bs2_all_transforms.yml with block_kernel_size 11,
# protopnet2d_unpadded_centered.yml,
# unpadded_centered_nb20_retinanet_bs2_bbox_baseline.yml)
TWO_D_BASE = [
    "--clip-grad", "--clip-val", "0.01", "--dataset-type",
    "unpadded_centered_sequences", "--kfolds", "5", "--n-sub-batches", "20",
    "--oversample-minority"]
TWO_D_FLAGS = {
    "cnn_linear_2d": TWO_D_BASE + [
        "--batch-size", "2", "--epochs", "10", "--network", "cnn_linear_2d"],
    "cnn_linear_2d_fft": TWO_D_BASE + [
        "--batch-size", "2", "--epochs", "10", "--network", "cnn_linear_2d",
        "--with-fft"],
    "cnn_linear_2x1d": TWO_D_BASE + [
        "--batch-size", "2", "--epochs", "10", "--network", "cnn_linear_2x1d",
        "--two-dim-transforms", "win_slice", "win_warp", "row_shuffle",
        "horiz_flip", "--block-kernel-size", "11"],
    "protopnet_2d": TWO_D_BASE + [
        "--batch-size", "16", "--epochs", "10", "--network", "protopnet_2d",
        "--n-prototypes", "6", "--two-dim-transforms", "mag_warp",
        "row_shuffle", "win_warp"],
    "retinanet_2d": TWO_D_BASE + [
        "--batch-size", "2", "--epochs", "20", "--network", "retinanet_2d"],
}
# protopnet_2d's schedule cut to every stage and one push
PPNET_2D_CUT = ["--n-warm-epochs", "1", "-pse", "2", "--push-every-n", "1",
                "--n-push-iters", "1"]
# the siamese networks (the ``siamese`` phase) at config 1's width: its
# flags without folds, which the siamese trainer refuses (no yml of the
# JAX package names them), over the ``main`` holdout; then
# siamese_pretrained with each time layer as config 1, its backbone
# spliced from siamese_cnn_linear's checkpoint
SIAMESE = ("siamese_cnn_linear", "siamese_cnn_lstm", "siamese_cnn_transformer")
TIME_LAYERS = ("none", "lstm", "transformer")
SIAMESE_BASE = [
    "--clip-val", "0.01", "--clip-grad",
    "--dataset-type", "unpadded_centered_sequences", "--epochs", "10",
    "--batch-size", "16", "--n-sub-batches", "20"]
SIAMESE_FLAGS = {
    **{name: SIAMESE_BASE + ["--network", name] for name in SIAMESE},
    **{"siamese_pretrained_" + layer: CONFIG1_FLAGS + [
        "--network", "siamese_pretrained", "--siamese-time-layer", layer]
       for layer in TIME_LAYERS}}
# the remaining base networks (the ``backbones`` phase) under config 1's
# cnn_linear; the autoencoder over basic_cnn_ae on its dataset type, as
# the siamese networks;
# config 5's ProtoPNet over vgg11_bn, cut to one stage and a push
BACKBONES = ("vgg11", "vgg11_bn", "vgg13", "vgg13_bn", "senet18", "senet154",
             "se_resnet18", "se_resnet50", "se_resnet101", "se_resnet152",
             "se_resnext50_32x4d", "se_resnext101_32x4d", "unet",
             "basic_cnn_ae")
BACKBONE_FLAGS = {
    **{"cnn_linear_" + base: CONFIG1_FLAGS + ["--base-network", base]
       for base in BACKBONES},
    # over the main holdout: its windows' targets are NaN, so the
    # patients have no class to stratify 5 folds by
    "autoencoder": SIAMESE_BASE + [
        "--network", "autoencoder", "--base-network", "basic_cnn_ae",
        "--dataset-type", "unpadded_downsampled_autoencoder_sequences"],
    "protopnet_vgg11_bn": CONFIG5_FLAGS + ["--base-network", "vgg11_bn"]}
PPNET_VGG_CUT = ["--epochs", "1", "--n-warm-epochs", "1", "-pse", "1",
                 "--push-every-n", "1", "--n-push-iters", "1"]
# one name a block, trained through the CLI and (but ProtoPNet) held card
# vs CPU; the other names differ from one of these in depth or groups
BACKBONE_BY_BLOCK = ("cnn_linear_vgg11", "cnn_linear_vgg13_bn",
                     "cnn_linear_senet18", "cnn_linear_se_resnet50",
                     "cnn_linear_se_resnext50_32x4d", "cnn_linear_senet154",
                     "cnn_linear_unet", "cnn_linear_basic_cnn_ae",
                     "autoencoder", "protopnet_vgg11_bn")
CONFIG_FLAGS = {"config1": CONFIG1_FLAGS, "config2": CONFIG2_FLAGS,
                "config3": CONFIG3_FLAGS, "config4": CONFIG4_FLAGS,
                # config 4's stateful fold, config 1's folds trained at once
                # (the JAX benchmark's config 7), config 5
                "config4_unshuffled": CONFIG4_FLAGS + ["--unshuffled"],
                "config7": CONFIG1_FLAGS + ["--parallel-folds"],
                "config5": CONFIG5_FLAGS, **SEQUENCE_FLAGS, **TWO_D_FLAGS,
                **SIAMESE_FLAGS, **BACKBONE_FLAGS}

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
        "lstm_launches_per_call": sum(
            e.count for e in kernels if "lstm_fwd_kernel" in e.key
            or "lstm_bwd_kernel" in e.key) / reps,
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
    """``warp<R>`` or ``strip`` for a dtw kernel's mangled name, an LSTM
    kernel's name with its mangled template arguments, else None."""
    rows = re.search(r"dtw_warp_kernelILi(\d+)E", symbol)
    if rows:
        return "warp" + rows.group(1)
    lstm = re.search(r"(lstm_\w+?_kernel)(?:I(\w+?)EEv)?", symbol)
    if lstm:
        return lstm.group(1) + ("<{}>".format(lstm.group(2))
                                if lstm.group(2) else "")
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


def dtw_bound(la, lb, per_cell, sms, clock_hz):
    """Least time for one dtw call: each pair's la + lb real samples and
    both lengths read once and its distance written once at the HBM rate
    (a padded sample is no work the function must do), against the la * lb
    cells' FP32 instructions at the SMs' issue rate (``per_cell`` from the
    SASS)."""
    bsz = la.numel()
    cells = float((la.double() * lb.double()).sum())
    bytes_moved = 4 * float((la.double() + lb.double()).sum()) + 3 * bsz * 4
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
                               warmup=0, reps=3)
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
        bound = dtw_bound(la, lb, per_cell[kernel]["fp32_per_cell"], sms,
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
            "fp32_per_cell": {k: v["fp32_per_cell"]
                              for k, v in per_cell.items()}}


# the nested network's LSTM: one patient of 2,048 windows, 128 features a
# window, 128 units, under bf16 compute; and cnn_lstm's (batch 16, S 20,
# 16 units) with a carry passed in, float32
LSTM_NESTED = (1, 2048, 128, 128, "bfloat16", False)
LSTM_CARRY = (16, 20, 128, 16, "float32", True)
LSTM_NESTED_F32 = LSTM_NESTED[:4] + ("float32", False)
# kernel against loop (tests/test_torch_lstm_cuda.py states why): float32
# outputs and carry; each gradient relative to its largest element, in
# float32 and where bf16 compute casts it
LSTM_OUT_ATOL, LSTM_GRAD_RTOL, LSTM_BF16_GRAD_RTOL = 2e-5, 2e-4, 1 / 64


@contextlib.contextmanager
def lstm_loop_only():
    """Every LSTM runs the plain loop (``lstm_reference``) inside."""
    from deepards_tpu_torch.ops import lstm as lstm_ops

    plan = lstm_ops.kernel_plan
    lstm_ops.kernel_plan = lambda xi, w_h: None
    try:
        yield
    finally:
        lstm_ops.kernel_plan = plan


def lstm_case(shape, seed=SEED):
    """A seeded LSTM on the card at ``shape`` (LSTM_NESTED's layout), its
    input, carry and loss weights, and ``step()``: one forward and
    backward, returning the outputs, carry and every gradient."""
    import torch

    from deepards_tpu_torch.models.recurrent import LSTM

    batch, steps, features, hidden, dtype, carry = shape
    dtype = getattr(torch, dtype)
    dev = torch.device("cuda")
    lstm = LSTM(features, hidden).reset_parameters(
        torch.Generator().manual_seed(seed)).to(dev)
    gen = torch.Generator(device=dev).manual_seed(seed)
    x = torch.randn((batch, steps, features), generator=gen, device=dev)
    x = x.to(dtype).requires_grad_()
    start = None
    if carry:
        start = tuple(0.5 * torch.randn((batch, hidden), generator=gen,
                                        device=dev) for _ in range(2))
        start = tuple(t.requires_grad_() for t in start)
    weights = [torch.randn(s, generator=gen, device=dev) for s in (
        (batch, steps, hidden), (batch, hidden), (batch, hidden))]
    params = dict(lstm.named_parameters())
    leaves = [x, *params.values(), *(start or ())]
    names = ["x", *params, *(["c0", "h0"] if carry else [])]

    def step():
        if dtype == torch.bfloat16:
            cast = {k: v.to(dtype) for k, v in params.items()}
            (c, h), out = torch.func.functional_call(lstm, cast, (x, start))
        else:
            (c, h), out = lstm(x, start)
        loss = sum((t * w).sum() for t, w in zip((out, c, h), weights))
        grads = torch.autograd.grad(loss, leaves)
        got = {"out": out.detach(), "c": c.detach(), "h": h.detach()}
        got.update({"d" + n: g for n, g in zip(names, grads)})
        return got

    return step


def lstm_gaps(got, want, bf16):
    """Each tensor's largest gap, kernel against loop, with its limit."""
    out = {}
    for name, w in want.items():
        gap = float((got[name].double() - w.double()).abs().max())
        if name in ("out", "c", "h"):
            limit = LSTM_OUT_ATOL
        else:
            rtol = LSTM_BF16_GRAD_RTOL if bf16 else LSTM_GRAD_RTOL
            limit = rtol * float(w.double().abs().max())
        out[name] = {"gap": gap, "limit": limit}
    return out


def graphed(step):
    """``step`` captured in a CUDA graph (after one warm-up on the side
    stream); returns the replay."""
    import torch

    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        step()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        step()
    return graph.replay


def phase_lstm():
    """The LSTM kernels against the loop on the card (the nested shape,
    and cnn_lstm's with a carry), then at the nested shape, forward and
    backward each captured in a graph: the kernels' time and its split
    (forward kernel, backward kernel, the rest), the loop's (the LSTM
    alone as the nested step ran it before the kernels), cuDNN's
    ``torch.nn.LSTM`` (``library_ms``; the port never calls it) and the
    latency floor (2 x 2,048 hand-offs and cluster barriers at the
    kernels' cluster and block, the probe kernel)."""
    import torch

    from deepards_tpu_torch.ops import lstm as lstm_ops

    checks = {}
    for label, shape in (("nested", LSTM_NESTED),
                         ("nested_float32", LSTM_NESTED_F32),
                         ("cnn_lstm_carry", LSTM_CARRY)):
        step = lstm_case(shape)
        before = lstm_ops.launches
        got = step()
        launched = lstm_ops.launches - before
        with lstm_loop_only():
            want = step()
        torch.cuda.synchronize()
        gaps = lstm_gaps(got, want, shape[4] == "bfloat16")
        bad = {k: v for k, v in gaps.items() if not v["gap"] <= v["limit"]}
        if launched != 2 or bad:
            raise AssertionError("lstm kernel vs loop at {}: {} launches, "
                                 "over: {}".format(label, launched, bad))
        checks[label] = {"launches": launched,
                         "max_gap": max(v["gap"] for v in gaps.values()),
                         "gaps": gaps}

    step = lstm_case(LSTM_NESTED)
    kernel = graphed(step)
    with lstm_loop_only():
        plain = graphed(step)
    kernel_ms = cuda_ms(kernel, warmup=3, reps=20)
    plain_ms = cuda_ms(plain, warmup=1, reps=5)
    prof = device_breakdown(kernel, reps=5, top=12)
    split = {"forward": 0.0, "backward": 0.0, "rest": 0.0}
    for e in prof["top"]:
        part = ("forward" if "lstm_fwd_kernel" in e["name"] else
                "backward" if "lstm_bwd_kernel" in e["name"] else "rest")
        split[part] += e["ms_per_call"]
    split["rest"] += prof["device_ms_per_call"] - sum(split.values())
    plain_prof = device_breakdown(plain, reps=1, top=4)

    batch, steps, features, hidden = LSTM_NESTED[:4]
    cudnn = torch.nn.LSTM(features, hidden, batch_first=True).cuda()
    xf = torch.randn((batch, steps, features), device="cuda",
                     requires_grad=True)

    def library():
        out, _ = cudnn(xf)
        torch.autograd.grad(out.sum(), [xf, *cudnn.parameters()])

    library_ms = cuda_ms(library, warmup=2, reps=10)
    plan = lstm_ops.lstm_plan(
        batch, hidden, torch.float32,
        torch.cuda.get_device_properties(0).multi_processor_count)
    probe_ms = lstm_ops.barrier_probe_ms(plan.cluster, plan.threads, steps)
    floor_ms = 2 * probe_ms
    out = {"shape": "B {} S {} F {} H {} bf16".format(*LSTM_NESTED[:4]),
           "plan": plan._asdict(),
           "ms": kernel_ms, "device_ms": prof["device_ms_per_call"],
           "launches": prof["kernel_launches_per_call"],
           "device_ms_by_part": split, "top": prof["top"][:6],
           "plain_ms": plain_ms,
           "plain_device_ms": plain_prof["device_ms_per_call"],
           "plain_launches": plain_prof["kernel_launches_per_call"],
           "library_ms": library_ms, "library": "torch.nn.LSTM (cuDNN), "
           "float32, forward and backward, eager",
           "barrier_probe_ms": probe_ms, "floor_ms": floor_ms,
           "share_of_floor": floor_ms / prof["device_ms_per_call"],
           "checks": checks,
           "tolerance": "out/c/h atol {}; gradients {} of their largest "
           "element, {} under bf16 compute".format(
               LSTM_OUT_ATOL, LSTM_GRAD_RTOL, LSTM_BF16_GRAD_RTOL)}
    emit("lstm_kernel", **out)
    print("lstm {}: {} ms graphed ({} ms on the device: forward {}, backward"
          " {}, rest {}), plain loop {} ms ({} kernels), cuDNN {} ms, floor "
          "{} ms".format(out["shape"], kernel_ms, out["device_ms"],
                         split["forward"], split["backward"], split["rest"],
                         plain_ms, out["plain_launches"], library_ms,
                         floor_ms), flush=True)
    return out


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


TRAIN_EPOCHS = 2  # the configs train 10
# card vs CPU after each of 3 steps from the same params and batches, TF32
# off: losses within 1e-4 and every element of every param within 1e-5,
# in float32 and in float64, but for two kinds of element in float32:
# - the tensors named by ``BY_GRADIENT``'s prefixes: the first conv, and
#   for resnet18 its stem and first stage, whose gradient sums cancel, so
#   that two float32 summation orders move some of their elements apart
#   by more than 1e-5 in 3 steps.  Each is held instead (a) by its float32
#   gradient on the card against the CPU's float64 one at the check's 3
#   batches, within 2e-2 of the largest float64 element: above the CPU's
#   own float32 reading (``grad_err.cpu``) and below what a zero gradient
#   or another batch's gradient gives (``grad_controls``, which must
#   exceed the limit), and (b) by the float64 run, which holds every
#   element;
# - Adam's (config 3).  Its first update is lr * g / (|g| + eps), about
#   lr * sign(g): an element is not held after it where gradients within
#   4x the CPU's own float32 error in its tensor (of the float64 gradient)
#   could move that update by more than 1e-5 (``skipped_noise_level``).
#   Its later updates divide moments of gradients that cancel, and at
#   this batch float32's last bits move most elements by up to lr
#   (``python -m deepards_tpu_torch.train.adam_spread`` reads this by
#   batch, params and targets).  So float32 Adam is held after its first
#   step and by the losses of steps 1 and 2 (the third is taken after the
#   second update), and the card's Adam over all 3 steps by the float64
#   run: the card runs training's ``capturable`` Adam, whose step count is
#   float32, and the CPU ``Float32CountAdam``, the same arithmetic
#   written out.
# A network of ``FLOAT32_PARAM_STEPS`` holds its float32 params after its
# first steps only; one of ``SORTING`` takes the CPU's sort picks on the
# card.
# Each float32 check must pass the CPU against itself with the batch's
# rows permuted (``cpu_rows_permuted``), and each check must fail a
# planted fault: the head's bias with its updates skipped (``planted``),
# and for Adam in float64 torch's own Adam, whose bias corrections are
# float64.
TRAIN_STEP_ATOL = dict(loss=1e-4, params=1e-5, grad=2e-2)
BY_GRADIENT = {
    "config1": ("breath_block.conv0.",),
    "config2": ("breath_block.convs.0.", "breath_block.norms.0.",
                "breath_block.blocks.0.", "breath_block.blocks.1."),
    "config3": ("breath_block.conv0.",),
    "config4": ("breath_block.conv0.",),
    "config4_unshuffled": ("breath_block.conv0.",),
    "config7": ("breath_block.conv0.",),
    "config5": ("breath_block.conv0.",),
    # the LSTM-only networks have no conv
    **{name: () if name in LSTM_ONLY else ("breath_block.conv0.",)
       for name in SEQUENCE_FLAGS},
    **{name: ("breath_block.conv0.",) for name in TWO_D_FLAGS},
    **{name: ("breath_block.conv0.",) for name in SIAMESE_FLAGS},
    # the new backbones' first conv weight: the bias of a conv a norm
    # follows has a zero gradient, which float32 cannot scale
    **{name: ("breath_block.convs.0.weight",) for name in BACKBONE_FLAGS},
    "cnn_linear_unet": ("breath_block.double_convs.0.convs.0.",),
}
# Networks that select by sorting: each window's feature at the lower
# median (cnn_linear_compr_to_rf), or the mean of the middle two (the
# nested networks' window medians).  Where two candidates are within
# rounding of each other, two runs can pick different breaths: the value
# is the same, but the gradient goes to another breath, and the params
# part by far more than rounding.  So card_vs_cpu records every
# ``torch.sort`` of the CPU's float64 run (and gradients) and replays it
# in every other run, card and CPU: each picks the same breaths and every
# step is held.  The card's own sort is held apart, by ``sort_mode``'s
# bound.
SORTING = ("cnn_linear_compr_to_rf",) + NESTED_NETWORKS
# float32 params held after this many of the 3 steps, the later ones by
# the float64 run and the float32 losses alone: the nested transformer's
# float32 params on the card part from the CPU's by a little more than
# 1e-5 in a few backbone conv elements after steps 2 and 3, with the same
# picks, while float64 agrees to rounding (``cpu_vs_float64`` and
# ``device_vs_float64`` read each side's float32 distance from float64)
#
# The first conv's float32 gradient is ~1e-3 of its scale off float64's
# on either device (``BY_GRADIENT``'s reason).  Where one of its elements
# swings across the clamp (``--clip-val`` 0.01) on one side only, the
# conv's params part by lr x 1.9 x 0.02 = 3.8e-5 (Nesterov) and the next
# step's gradients of the whole backbone follow (``float32_gap.py
# --network`` reads the swings).  ``clamp_mode`` replays the float64
# run's clamp decisions in every other run, so those elements take the
# same bound on both sides.
#
# Measured with the replay (an H100 at 700 W and its host): siamese_cnn_linear now holds all 3 steps.  siamese_cnn_transformer
# does not: after step 3 each side's float32 leaves float64 by 3.8e-5
# (CPU) / 3.4e-5 (card), 35 held elements over, while the CPU with its
# rows permuted stays within 3.6e-6: the first conv's elements below the
# clamp, which keep their own float32 error, move the backbone.  vgg13_bn,
# senet18 and se_resnext50_32x4d (one block a stage) fail the CPU against
# itself with its rows permuted after step 3 (8 / 231 / 1 held elements
# over; se_resnext50's float32 within 8.3e-6 of float64, at the limit's
# edge), so float32 cannot hold their step 3.
FLOAT32_PARAM_STEPS = {"cnn_to_nested_transformer": 1,
                       "siamese_cnn_transformer": 2,
                       "cnn_linear_vgg13_bn": 2, "cnn_linear_senet18": 2}
# Networks whose runs keep their own clamp decisions (no ``clamp_mode``).
# se_resnext50_32x4d's float32 takes its own decision at 1 to 81 elements
# of a clamp call where float64 takes the other (of 11,798-42,646 it
# clamps); replayed, they move both CPU float32 runs so that the one
# with its rows permuted leaves the other by 1.18e-5 in one held element
# after step 3, where with their own decisions no held element moves by
# more than 1e-5 (the largest, 1.18e-5, is in the first conv, held by its
# gradient), on 4 threads as on 8 (``python3 float32_gap.py --device cpu
# --network cnn_linear_se_resnext50_32x4d --control 4,8`` on an H100's
# host).
OWN_CLAMPS = ("cnn_linear_se_resnext50_32x4d",)



def remapped(permuted, nested):
    """Recorded sort indices as a run over rows permuted by ``permuted``
    (card_vs_cpu's control) reads them: a nested window's breaths, the
    sorted axis, reordered; else the batch's samples."""
    import torch

    if nested:
        inverse = torch.as_tensor(np.argsort(permuted))
        return lambda indices: inverse[indices]
    return lambda indices: indices[torch.as_tensor(permuted)]


def sort_mode(records, replay=None, remap=None, gaps=None):
    """A mode over one run: each ``torch.sort`` it calls is recorded in
    ``records`` as (indices, input), both on the CPU; or, with ``replay``
    (a run's records, in call order), answered with the recorded indices
    (mapped by ``remap`` for a run over permuted rows) and its own input's
    values at them, so that the run picks the elements the recorded one
    picked and its gradient reaches them.  With ``gaps``, each replayed
    call also sorts for itself and appends {own: the largest distance of
    its own sorted values from the replayed ones, bound: twice the largest
    distance of its input from the recorded one, rank_off: ``own`` for
    indices one rank off}: sorting moves no value by more than its input
    moved, so ``own`` must stay within ``bound``, and ``rank_off`` (a
    faulty sort) must not."""
    import torch
    from torch.overrides import TorchFunctionMode

    pending = iter(replay or ())

    class Mode(TorchFunctionMode):
        def __torch_function__(self, func, types, args=(), kwargs=None):
            kwargs = kwargs or {}
            out = func(*args, **kwargs)
            if func is not torch.sort:
                return out
            x = args[0]
            if replay is None:
                records.append((out.indices.cpu(), x.detach().cpu()))
                return out
            dim = kwargs.get("dim", args[1] if len(args) > 1 else -1)
            indices, recorded = next(pending)
            if remap is not None:
                indices = remap(indices)
            indices = indices.to(x.device)
            values = torch.gather(x, dim, indices)
            if gaps is not None:
                own = out.values.detach().double()
                off = torch.gather(x.detach(), dim, indices.roll(1, dim))
                moved = (x.detach().cpu().double() - recorded.double()).abs()
                gaps.append({
                    "own": float((own - values.detach()).abs().max()),
                    "bound": 2 * float(moved.max()),
                    "rank_off": float((own - off).abs().max())})
            return torch.return_types.sort((values, indices))

    return Mode()


def clamp_mode(model, records, replay=None):
    """A mode over one run of ``model`` with a clipped optimizer: each
    clamp ``ClippedOptimizer.step`` calls (``torch._foreach_clamp_min_``
    to -clip, then ``torch._foreach_clamp_max_`` to +clip) is recorded in
    ``records`` as {param name: the mask of the elements it clamps}, on
    the CPU; or, with ``replay`` (a run's records, in call order), each
    call is made and then every element the record clamped is set to the
    call's bound, so the run takes the recorded run's clamp decisions
    where that run clamped and its own elsewhere.  The training path has
    no hook: outside this mode the clamp is the optimizer's own."""
    import torch
    from torch.overrides import TorchFunctionMode

    clamps = (torch._foreach_clamp_min_, torch._foreach_clamp_max_)
    pending = iter(replay or ())

    class Mode(TorchFunctionMode):
        def __torch_function__(self, func, types, args=(), kwargs=None):
            kwargs = kwargs or {}
            if func not in clamps:
                return func(*args, **kwargs)
            grads, bound = args[0], args[1]
            name_of = {id(p.grad): n for n, p in model.named_parameters()
                       if p.grad is not None}
            names = [name_of[id(g)] for g in grads]
            if replay is None:
                low = func is clamps[0]
                records.append({n: (g < bound if low else g > bound).cpu()
                                for n, g in zip(names, grads)})
                return func(*args, **kwargs)
            out = func(*args, **kwargs)
            masks = next(pending)
            with torch.no_grad():
                for n, g in zip(names, grads):
                    g.masked_fill_(masks[n].to(g.device), bound)
            return out

    return Mode()


# a nested network's step in card_vs_cpu: one patient of NESTED_REAL
# windows in a bucket of NESTED_BUCKET (as many breaths as config 1's batch)
NESTED_REAL, NESTED_BUCKET = 12, 16
TRAIN_SERVE_ATOL = 1e-5  # the same params and batch on one device
MEASURE_WINDOWS = 4096  # the device-cache epoch timed: 256 steps of 16
# the eager epoch's cache: 64 steps of 16 (cut from 4096 for the script's
# time; an eager step takes ~45 ms, host-bound)
EAGER_MEASURE_WINDOWS = 1024
STEP_NUMBERS = {}  # config -> train_numbers' readings of this run


def config_conf(name, *flags):
    """The ``Configuration`` of benchmark config ``name``'s flags and
    ``flags``."""
    from deepards_tpu_torch.cli.train import build_parser
    from deepards_tpu_torch.config.config import Configuration

    return Configuration(build_parser().parse_args(
        CONFIG_FLAGS[name] + list(flags)))


class CacheView:
    """The part of a dataset the trainer's device-cache epoch reads: a
    window cache and its current indices (all of them)."""

    dataset_type = "unpadded_centered_sequences"

    def __init__(self, cache):
        self.cache = cache

    def current_indices(self):
        return np.arange(len(self.cache), dtype=np.int64)


def config_cohort(workdir, conf):
    """The seeded synthetic cohort (10 patients x 400 breaths) of a
    config: all_data for k-fold configs, shared by them, and the ``main``
    holdout's two directories for a holdout config.  Returns (data path,
    cohort file)."""
    from deepards_tpu_torch.data.synthetic import generate_cohort

    if conf.get("kfolds"):
        cohort_dir, subdirs = os.path.join(workdir, "cohort"), ("all_data",)
    else:
        cohort_dir = os.path.join(workdir, "cohort_holdout")
        subdirs = ("aim1_70_30_training", "aim1_70_30_testing")
    cohort = os.path.join(cohort_dir, "cohort-description.csv")
    if not os.path.exists(cohort):
        cohort = generate_cohort(cohort_dir, n_patients=10,
                                 n_breaths_per_patient=400, seed=SEED,
                                 subdirs=subdirs)
    return cohort_dir, cohort


def train_config(workdir, device, name="config1", epochs=TRAIN_EPOCHS,
                 extra=(), folds=None):
    """Config ``name`` through ``deepards_tpu_torch.cli.train.main`` on a
    seeded synthetic cohort, ``epochs`` epochs of every fold (``extra``
    flags after the config's; ``folds``: the folds they train, default
    all), with its checkpoints and results checked: a classifier's AUC
    meters and patient records, a regressor's test MAE, MSE and r2."""
    from deepards_tpu_torch.cli.train import main as train_main
    from deepards_tpu_torch.data.dataset import ARDSRawDataset
    from deepards_tpu_torch.train import checkpoint as ckpt

    conf = config_conf(name)
    cohort_dir, cohort = config_cohort(workdir, conf)
    results_dir = os.path.join(workdir, name + "_results")
    models_dir = os.path.join(workdir, name + "_models")
    kfolds = conf.get("kfolds")
    windows = len(ARDSRawDataset(
        cohort_dir, 1, cohort, conf.n_sub_batches, conf.dataset_type,
        kfold_num=0 if kfolds else None, total_kfolds=kfolds).cache)
    t0 = time.perf_counter()
    trainer = train_main(CONFIG_FLAGS[name] + [
        "--epochs", str(epochs), "--data-path", cohort_dir,
        "--cohort-file", cohort, "--results-dir", results_dir,
        "--save-model", name + ".pt", "--saved-models-dir", models_dir,
        "--device", device] + list(extra))
    seconds = time.perf_counter() - t0
    res = trainer.results
    kind = trainer.spec.kind
    classifier = kind == "classifier"
    meters = {"classifier": ("test_auc",),
              "regressor": ("test_mae", "test_mse", "test_r2"),
              "autoencoder": ("test_loss",),
              "siamese": ("accuracy",)}[kind]
    trained = range(kfolds or 1) if folds is None else folds
    folds = {}
    for fold in trained:
        losses = res.get_meter("loss", fold).values
        tested = {m: res.reporting.meters.get("{}_fold_{}".format(m, fold))
                  for m in meters}
        rows = [r for r in res.results if r["fold_num"] == fold]
        path = os.path.join(models_dir, "{}-fold{}".format(name, fold)
                            if kfolds else name)
        if not losses or not np.isfinite(losses).all():
            raise AssertionError("{} fold {}: losses {}".format(
                name, fold, losses))
        # an autoencoder's test losses are one a step
        bad = [m for m, meter in tested.items()
               if meter is None or len(meter) < epochs
               or (kind != "autoencoder" and len(meter) != epochs)
               or (not classifier and not np.isfinite(meter.values).all())]
        if bad or (classifier and not rows):
            raise AssertionError("{} fold {}: test meters {} or patient "
                                 "rows missing".format(name, fold, bad))
        if ckpt.load_scaling(path) is None or "opt_state" not in \
                ckpt.restore(path):
            raise AssertionError("{} fold {}: checkpoint or its scaling "
                                 "sidecar missing".format(name, fold))
        folds[fold] = {"steps": len(losses), "last_loss": losses[-1],
                       **{m: tested[m].values[-epochs:] for m in meters}}
        if classifier:
            folds[fold]["patients"] = len(rows)
    names = os.listdir(results_dir)
    parts = ("_patient_results.json", "_aggregate_results.json",
             "_maximal_results.json") if classifier else ()
    for part in parts:
        if not any(n.endswith(part) for n in names):
            raise AssertionError("results file *{} missing".format(part))
    if not any(n.startswith("meters_") for n in names) or not any(
            "_results_" in n for n in names):
        raise AssertionError("meters or results record missing")
    shape = (conf.n_sub_batches, C, L)
    reduced = {"epochs": "10 -> {}".format(epochs),
               "cohort": "synthetic, 10 patients x 400 breaths ({} windows "
                         "of {}) in place of ~100 patients x 24 h".format(
                             windows, shape)}
    print("reduced: " + json.dumps({name: reduced}), flush=True)
    return trainer, models_dir, {
        "seconds": seconds, "windows": windows, "folds": folds,
        "results_files": sorted(names), "reduced": reduced,
        "compute_dtype": trainer.conf.get("compute_dtype")}


def random_targets(rng, n, conf):
    """Targets of ``n`` windows for config ``conf``: one-hot classes, or a
    regressor's outputs as z-scored breath metadata, so that its losses
    are O(1) as a classifier's are and the absolute limits read alike."""
    from deepards_tpu_torch.models.registry import (
        get_network_spec,
        n_bm_features,
    )

    if get_network_spec(conf.network).kind == "regressor":
        width = n_bm_features(conf.conf)
        return rng.normal(size=(n, width)).astype(np.float32)
    return np.eye(2, dtype=np.float32)[rng.integers(0, 2, n)]


class GradientsOnly:
    """An optimizer for ``TrainState`` that leaves the params and their
    gradients as the backward left them."""

    def __init__(self, model):
        self.params = list(model.parameters())

    def zero_grad(self):
        for p in self.params:
            p.grad = None

    def step(self):
        pass


class Float32CountAdam:
    """Adam as torch's ``capturable`` Adam, training's optimizer on the
    card, computes it: the step count a float32 tensor, the bias
    corrections float32 values computed from it (as optax computes them
    too), the moments and the update in the params' dtype, in the same
    order of operations."""

    EPS = 1e-8  # torch's and optax's default

    def __init__(self, params, lr, betas=(0.9, 0.999), eps=EPS):
        import torch

        self.params = list(params)
        self.lr, (self.beta1, self.beta2), self.eps = lr, betas, eps
        self.exp_avg = [torch.zeros_like(p) for p in self.params]
        self.exp_avg_sq = [torch.zeros_like(p) for p in self.params]
        self.count = torch.zeros((), dtype=torch.float32)

    def zero_grad(self):
        for p in self.params:
            p.grad = None

    def step(self):
        import torch

        with torch.no_grad():
            self.count += 1
            # -lr / (1 - beta1 ** t) and sqrt(1 - beta2 ** t), in float32
            step_size = torch.reciprocal(
                (torch.pow(self.beta1, self.count) - 1) / self.lr)
            root = (1 - torch.pow(self.beta2, self.count)).sqrt()
            for p, m, v in zip(self.params, self.exp_avg, self.exp_avg_sq):
                m.lerp_(p.grad, 1 - self.beta1)
                v.mul_(self.beta2).addcmul_(p.grad, p.grad,
                                            value=1 - self.beta2)
                p.addcdiv_(m, (v.sqrt() / root + self.eps) / step_size)


def train_card_vs_cpu(device, name="config1"):
    """Three steps of config ``name``'s network at full width and batch
    (a nested network: one patient of NESTED_REAL windows a step; a
    siamese network: triplets of an anchor, its positive and its negative
    a row), dropout off, on the device and on the CPU from the same
    params and batches, in float32 and in float64: losses and every param
    element after each step, as ``TRAIN_STEP_ATOL`` says, with the
    controls it names; every run replays the CPU float64 run's sort picks
    (``sort_mode``) and clamp decisions (``clamp_mode``), the card's own
    sort held by ``sort_mode``'s bound.  The CPU's sides come from the
    worker process where ``CPU_SIDES`` runs this network's, else they run
    here.  When a check fails, its readings are printed
    (``card_vs_cpu_failed``) before it raises."""
    fields = {"atol": TRAIN_STEP_ATOL, "by_gradient": {}}
    cpu = None
    if CPU_SIDES is not None and name in CPU_SIDES.names:
        cpu = CPU_SIDES.sides(name)
    try:
        return _train_card_vs_cpu(device, name, fields, cpu)
    except AssertionError:
        emit("card_vs_cpu_failed", network=name, **fields)
        raise


def over(got, want, limit, held=None, skip=None):
    """Per held tensor, the count of elements beyond ``limit`` that
    ``skip`` does not mask; tensors with none left out."""
    counts = {}
    for n in held or want:
        bad = (got[n] - want[n]).abs() > limit
        if skip is not None and n in skip:
            bad &= ~skip[n]
        if bad.any():
            counts[n] = int(bad.sum())
    return counts


def largest(got, want):
    """(the largest distance of ``got`` from ``want``, its tensor)."""
    errs = {n: float((got[n] - want[n]).abs().max()) for n in want}
    worst = max(errs, key=errs.get)
    return errs[worst], worst


class CardVsCpu:
    """The setup of ``train_card_vs_cpu`` for network ``name``, the same
    in every process (params, batches and permutation drawn from seeds),
    and its runs: ``run`` (3 steps) and ``gradients`` (one batch's)."""

    def __init__(self, name):
        import torch

        from deepards_tpu_torch.train.loop import Trainer

        self.name = name
        conf = self.conf = config_conf(name, "--device", "cpu")
        s, self.batch = conf.n_sub_batches, conf.batch_size
        batch = self.batch
        rng = np.random.default_rng(SEED + 2)
        trainer = self.trainer = Trainer(conf, verbose=False)
        self.nested = nested = trainer.spec.super_batch
        # a siamese row is three windows: anchor, positive, negative
        self.towers = 3 if trainer.spec.trainer == "siamese" else 1
        if nested:
            # a step is one patient: NESTED_REAL windows padded to its
            # bucket, and the "rows permuted" control reorders each
            # window's breaths (its norm's sums; its median is the same)
            raw = np.zeros((3, NESTED_BUCKET, s, C, L), np.float32)
            raw[:, :NESTED_REAL] = make_windows(
                rng, 3 * NESTED_REAL, s).reshape(3, NESTED_REAL, s, C, L)
            self.mu = np.float32([raw[:, :NESTED_REAL].mean()])
            self.std = np.float32([raw[:, :NESTED_REAL].std()])
            self.targets = random_targets(rng, 3, conf)[:, None]
            self.mask = np.zeros((1, NESTED_BUCKET), np.float32)
            self.mask[0, :NESTED_REAL] = 1.0
            self.permuted = rng.permutation(s)
        else:
            raw = make_windows(rng, 3 * batch * self.towers, s)
            self.mu = np.float32([raw.mean()])
            self.std = np.float32([raw.std()])
            self.targets = random_targets(rng, 3 * batch, conf)
            self.mask = np.ones(batch, np.float32)
            self.mask[-1] = 0.0  # one pad row
            # the batch's rows in another order, the pad row last
            self.permuted = np.append(rng.permutation(batch - 1), batch - 1)
        self.raw = raw
        trainer.n_sub_batches = s
        model = trainer.build_model().reset_parameters(
            torch.Generator().manual_seed(SEED))
        self.init = model.state_dict()
        self.names = [n for n, _ in model.named_parameters()]
        self.head_bias = self.names[-1]
        self.by_gradient = [n for n in self.names
                            if n.startswith(BY_GRADIENT[name])]
        self.adam = conf.optimizer == "adam"
        self.clip = bool(conf.get("clip_grad"))
        self.replays_clamps = self.clip and name not in OWN_CLAMPS
        self.limit = TRAIN_STEP_ATOL["params"]
        self.sorts = name in SORTING
        self.held_steps = {"float64": (1, 2, 3), "float32": (
            1, 2, 3)[:1 if self.adam else FLOAT32_PARAM_STEPS.get(name, 3)]}

    def held(self, f32):
        """The tensors held element by element: all but, in float32, the
        ones of ``BY_GRADIENT``."""
        return [n for n in self.names if not (f32 and n in self.by_gradient)]

    def graded(self):
        """The tensors whose gradients the checks read: ``BY_GRADIENT``'s,
        or every one for Adam's noise level."""
        return self.names if self.adam else self.by_gradient

    def build(self, dev, dtype):
        model = self.trainer.build_model()
        model.load_state_dict(self.init)
        return model.to(device=dev, dtype=dtype)

    @staticmethod
    def on(dev, dtype, *arrays):
        import torch

        return [torch.from_numpy(x).to(device=dev, dtype=dtype)
                for x in arrays]

    def batch_of(self, k, dev, dtype, rows=slice(None)):
        raw, targets, mask, batch = (self.raw, self.targets, self.mask,
                                     self.batch)
        if self.nested:
            return self.on(dev, dtype, raw[k:k + 1][:, :, rows], targets[k],
                           mask)
        sl = slice(k * batch, (k + 1) * batch)
        if self.towers == 3:  # (anchor, target, mask, positive, negative)
            anchor, positive, negative = (
                raw[t * 3 * batch:(t + 1) * 3 * batch][sl][rows]
                for t in range(3))
            return self.on(dev, dtype, anchor, targets[sl][rows],
                           mask[rows], positive, negative)
        return self.on(dev, dtype, raw[sl][rows], targets[sl][rows],
                       mask[rows])

    def steps(self, dev, dtype, model, optimizer):
        import torch

        from deepards_tpu_torch.data.pipeline import transform_batch
        from deepards_tpu_torch.train.nested_trainer import (
            make_nested_steps,
        )
        from deepards_tpu_torch.train.siamese_trainer import (
            make_siamese_steps,
        )
        from deepards_tpu_torch.train.steps import TrainState, make_train_step

        mu_d, std_d = self.on(dev, dtype, self.mu, self.std)
        state = TrainState(model, optimizer, torch.Generator(device=dev))
        if self.nested:
            step, _ = make_nested_steps(
                self.trainer.loss_fn,
                transform=lambda d: transform_batch(d, mu_d, std_d),
                dropout_active=False)
        elif self.towers == 3:
            step, _ = make_siamese_steps(
                lambda d: transform_batch(d, mu_d, std_d),
                dropout_active=False)
        else:
            step, _ = make_train_step(
                self.trainer.loss_fn,
                transform=lambda d: transform_batch(d, mu_d, std_d),
                dropout_active=False,
                target_mode=self.trainer.spec.target_mode)
        return state, step

    def modes(self, model, sort_records=None, replay=None, remap=None,
              gaps=None, clamps=None, clamp_replay=None):
        """The run's ``sort_mode`` (a network of SORTING) and
        ``clamp_mode`` over ``model`` (a clipped optimizer's), recording
        into ``sort_records`` and ``clamps`` or replaying ``replay`` and
        ``clamp_replay``."""
        stack = contextlib.ExitStack()
        if self.sorts:
            stack.enter_context(sort_mode(sort_records, replay, remap, gaps))
        if self.replays_clamps and (clamps is not None
                                    or clamp_replay is not None):
            stack.enter_context(clamp_mode(model, clamps, clamp_replay))
        return stack

    def run(self, dev, dtype, rows=slice(None), reference=True, replay=None,
            remap=None, gaps=None, clamps=None, clamp_replay=None):
        """Losses, params after each step, and the steps' sorts.
        Training's optimizer; on the CPU Adam is ``Float32CountAdam``
        unless not ``reference``.  ``clamps`` records the clamp
        decisions, ``clamp_replay`` replays them."""
        import torch

        from deepards_tpu_torch.train.steps import make_optimizer

        conf = self.conf
        model = self.build(dev, dtype)
        if self.adam and dev == "cpu" and reference:
            optimizer = Float32CountAdam(model.parameters(),
                                         conf.learning_rate)
        else:
            optimizer = make_optimizer(
                model.parameters(), conf.optimizer,
                learning_rate=conf.learning_rate,
                weight_decay=conf.weight_decay,
                clip_grad=self.clip, clip_val=conf.clip_val)
        state, step = self.steps(dev, dtype, model, optimizer)
        records = []
        losses, params = [], []
        with self.modes(model, records, replay, remap, gaps, clamps,
                        clamp_replay):
            for k in range(3):
                losses.append(float(step(state, *self.batch_of(
                    k, dev, dtype, rows))))
                # a copy: .to() of a float64 CPU tensor is the tensor
                # itself, which the next step changes
                params.append({n: v.detach().to("cpu", torch.float64,
                                                copy=True)
                               for n, v in model.state_dict().items()})
        return losses, params, records

    def gradients(self, dev, dtype, k, replay=None):
        """The gradients (before any clamp) of the ``graded`` tensors at
        the init for batch k, and the step's sorts: the train step with
        an optimizer that only zeroes the grads (torch's foreach Nesterov
        SGD adds its momentum into them in place)."""
        import torch

        model = self.build(dev, dtype)
        state, step = self.steps(dev, dtype, model, GradientsOnly(model))
        records = []
        with self.modes(model, records, replay):
            step(state, *self.batch_of(k, dev, dtype))
        grads = dict(model.named_parameters())
        return {n: grads[n].grad.detach().to("cpu", torch.float64, copy=True)
                for n in self.graded()}, records

    def noise_level(self, exact, single_cpu):
        """Adam's first update, lr * g / (|g| + eps), of an element that
        gradients within 4x the CPU's own float32 error in its tensor of
        the float64 one could move by more than the limit."""
        if not self.adam:
            return None
        lr = self.conf.learning_rate

        def first_update(g):
            return lr * g / (g.abs() + Float32CountAdam.EPS)

        level = {}
        for n in self.names:
            error = 4 * (single_cpu[0][n] - exact[0][n]).abs().max()
            level[n] = (first_update(exact[0][n] + error)
                        - first_update(exact[0][n] - error)) > self.limit
        return level

    def compare(self, got_steps, want_steps, held, skip=None):
        """After each step against ``want_steps``: the largest miss, and
        the elements over the limit, held (per tensor) and all (Adam's
        noise level is its first step's)."""
        out = []
        for k, (got, want) in enumerate(zip(got_steps, want_steps)):
            err, at = largest(got, want)
            out.append({"max_abs": err, "max_abs_at": at,
                        "over_atol_held": over(got, want, self.limit, held,
                                               skip if k == 0 else None),
                        "over_atol_all": sum(over(got, want,
                                                  self.limit).values())})
        return out


def cpu_float64_side(name):
    """The CPU's float64 side of ``train_card_vs_cpu``: the ``graded``
    gradients of the 3 batches with their sorts, the 3 steps with their
    sort picks and clamp decisions (which every other run replays), and
    the float64 checks that read the CPU alone."""
    import torch

    t0 = time.perf_counter()
    with one_block_a_stage(name, "card_vs_cpu"):
        c = CardVsCpu(name)
        exact, grad_sorts = [], []
        if c.graded():
            for k in range(3):
                g, records = c.gradients("cpu", torch.float64, k)
                exact.append(g)
                grad_sorts.append(records)
        clamps = []
        losses, steps, sorts = c.run("cpu", torch.float64, clamps=clamps)
        moved = {n: float((steps[-1][n] - c.init[n].double()).abs().max())
                 for n in c.by_gradient}
        adam_planted = None
        if c.adam:
            # torch's own Adam: float64 bias corrections
            _, torch_steps, _ = c.run("cpu", torch.float64, reference=False)
            adam_planted = sum(over(torch_steps[-1], steps[-1],
                                    c.limit).values())
    return {"exact": exact, "grad_sorts": grad_sorts, "losses": losses,
            "steps": steps, "sorts": sorts, "clamps": clamps,
            "moved": moved, "adam_planted": adam_planted,
            "seconds": time.perf_counter() - t0}


def cpu_float32_side(name, f64):
    """The CPU's float32 side: the ``graded`` gradients (float64's picks),
    the 3 steps replaying float64's picks and clamp decisions, and the
    CPU against itself with the batch's rows permuted (its readings)."""
    import torch

    t0 = time.perf_counter()
    with one_block_a_stage(name, "card_vs_cpu"):
        c = CardVsCpu(name)
        single = [c.gradients("cpu", torch.float32, k,
                              f64["grad_sorts"][k])[0]
                  for k in range(len(f64["exact"]))]
        losses, steps, _ = c.run("cpu", torch.float32, replay=f64["sorts"],
                                 clamp_replay=f64["clamps"])
        skip = c.noise_level(f64["exact"], single)
        perm_losses, perm_steps, _ = c.run(
            "cpu", torch.float32, rows=c.permuted, replay=f64["sorts"],
            remap=remapped(c.permuted, c.nested),
            clamp_replay=f64["clamps"])
        spread = {"max_abs_loss_by_step": np.abs(np.subtract(
            perm_losses, losses)).tolist(),
            "after_steps": c.compare(perm_steps, steps, c.held(True), skip)}
    return {"single": single, "losses": losses, "steps": steps,
            "spread": spread, "seconds": time.perf_counter() - t0}


class LocalSides:
    """The CPU sides of one network computed in this process, float64
    first."""

    def __init__(self, name):
        self.name = name
        self._f64 = None

    def float64(self):
        if self._f64 is None:
            self._f64 = cpu_float64_side(self.name)
        return self._f64

    def float32(self):
        return cpu_float32_side(self.name, self.float64())


def flipped(records, held):
    """``records`` (a float64 run's clamp decisions, a step's
    ``_foreach_clamp_min_`` call then its ``_foreach_clamp_max_``) with
    the first decision on a tensor of ``held`` replayed to the other
    bound: (the records, that tensor, its step), or None when no held
    tensor was clamped."""
    for call, masks in enumerate(records):
        for n in held:
            hits = masks[n].flatten().nonzero() if n in masks else ()
            if len(hits):
                out = [{k: v.clone() for k, v in ms.items()}
                       for ms in records]
                other = call + 1 if call % 2 == 0 else call - 1
                e = int(hits[0])
                out[call][n].view(-1)[e] = False
                out[other][n].view(-1)[e] = True
                return out, n, call // 2 + 1
    return None


def _train_card_vs_cpu(device, name, fields, cpu=None):
    """The checks of ``train_card_vs_cpu``: the card's runs against the
    CPU's sides (``cpu``: ``LocalSides`` unless given)."""
    import torch

    cpu = cpu or LocalSides(name)
    c = CardVsCpu(name)
    fields["batch"] = c.batch
    limit = c.limit
    f64 = cpu.float64()
    # the card's runs, each replaying the CPU float64 run's sort picks and
    # clamp decisions: the float32 gradients, the float64 and float32
    # steps, and the planted clamp decision flipped
    dev_single = [c.gradients(device, torch.float32, k,
                              f64["grad_sorts"][k])[0]
                  for k in range(len(f64["exact"]))]
    dev_runs, gaps = {}, {}
    for dtype_name, dtype in (("float64", torch.float64),
                              ("float32", torch.float32)):
        gaps[dtype_name] = []
        dev_runs[dtype_name] = c.run(device, dtype, replay=f64["sorts"],
                                     gaps=gaps[dtype_name],
                                     clamp_replay=f64["clamps"])[:2]
    held32 = c.held(True)
    flip = None
    if c.replays_clamps:
        flip = flipped(f64["clamps"], held32)
        if flip is None:
            raise AssertionError("no held tensor was clamped: the clamp "
                                 "replay would go unchecked")
        _, flip_steps, _ = c.run(device, torch.float32, replay=f64["sorts"],
                                 clamp_replay=flip[0])
    f32 = cpu.float32()

    failed = []
    for n in c.by_gradient:
        exact = f64["exact"]
        scale = max(float(g[n].abs().max()) for g in exact)
        check = fields["by_gradient"][n] = {
            "scale": scale,
            "grad_err": {side: [float((g[k][n] - exact[k][n]).abs().max())
                                / scale for k in range(3)]
                         for side, g in (("cpu", f32["single"]),
                                         ("device", dev_single))},
            "grad_controls": {
                "zero_gradient": [float(g[n].abs().max()) / scale
                                  for g in exact],
                "next_batch": [float((exact[k][n] - exact[(k + 1) % 3][n])
                                     .abs().max()) / scale
                               for k in range(3)]}}
        grad_limit = TRAIN_STEP_ATOL["grad"]
        if min(min(v) for v in check["grad_controls"].values()) <= \
                grad_limit:
            raise AssertionError("{}'s gradient limit would pass a zero or "
                                 "a wrong gradient: {}".format(
                                     n, check["grad_controls"]))
        if max(check["grad_err"]["device"]) > grad_limit:
            failed.append("{} gradient vs float64 {}".format(
                n, check["grad_err"]["device"]))
    noise_level = c.noise_level(f64["exact"], f32["single"])
    if c.adam:
        fields["skipped_noise_level"] = {
            n: int(m.sum()) for n, m in noise_level.items() if m.any()}
    fields["clamp_replay"] = {
        "replayed": c.replays_clamps, "calls": len(f64["clamps"]),
        "clamped": sum(int(m.sum()) for masks in f64["clamps"]
                       for m in masks.values())}
    for dtype_name, side in (("float64", f64), ("float32", f32)):
        f32_run = dtype_name == "float32"
        cpu_losses, cpu_steps = side["losses"], side["steps"]
        dev_losses, dev_steps = dev_runs[dtype_name]
        held = c.held(f32_run)
        held_steps = c.held_steps[dtype_name]
        skip = noise_level if f32_run and c.adam else None
        loss_errs = np.abs(np.subtract(dev_losses, cpu_losses))
        # a step's loss is the forward's, before its update
        held_losses = 2 if f32_run and c.adam else 3
        loss_err = float(np.max(loss_errs[:held_losses]))
        record = fields[dtype_name] = {
            "losses_device": dev_losses, "losses_cpu": cpu_losses,
            "max_abs_loss_by_step": loss_errs.tolist(),
            "losses_held": held_losses, "params_held_after_steps": held_steps}
        if c.sorts:
            # the card's own sort by step: within its bound, and the
            # planted sort one rank off beyond it
            g = record["own_sort"] = gaps[dtype_name]
            if len(g) != 3:
                failed.append("{}: {} sorts replayed in 3 steps".format(
                    dtype_name, len(g)))
            if any(x["own"] > x["bound"] * (1 + 1e-9) for x in g):
                failed.append("{} the card's own sort {}".format(
                    dtype_name, g))
            if any(x["rank_off"] <= x["bound"] for x in g):
                raise AssertionError("the {} sort check would pass a sort "
                                     "one rank off: {}".format(dtype_name,
                                                               g))
        if loss_err > TRAIN_STEP_ATOL["loss"]:
            failed.append("{} loss {}".format(dtype_name, loss_err))
        for k, reading in enumerate(c.compare(dev_steps, cpu_steps, held,
                                              skip), 1):
            record["after_step_{}".format(k)] = reading
            if k in held_steps and reading["over_atol_held"]:
                failed.append("{} after step {}: elements over {}: {}".format(
                    dtype_name, k, limit, reading["over_atol_held"]))
        # planted: the card's params after the last held step with the
        # head's bias left at its init, or the held tensor the steps move
        # most where they move the head's bias less than the limit (a
        # patient's class from step to step pulls it back and forth)
        last = held_steps[-1]
        moved = {n: float((cpu_steps[last - 1][n] - c.init[n].double())
                          .abs().max()) for n in held}
        fault = c.head_bias if moved.get(c.head_bias, 0.0) > limit else max(
            moved, key=moved.get)
        planted = dict(dev_steps[last - 1])
        planted[fault] = c.init[fault].double()
        caught = over(planted, cpu_steps[last - 1], limit, held,
                      skip if last == 1 else None)
        record["planted"] = {"fault": fault + " not updated",
                             "after_step": last,
                             "over_atol": sum(caught.values())}
        if not caught:
            raise AssertionError("the {} check would pass {} left at its "
                                 "init".format(dtype_name, fault))
        if f32_run:
            # each side's float32 against float64, the same picks
            for name_, got_steps in (("cpu", cpu_steps),
                                     ("device", dev_steps)):
                record["{}_vs_float64".format(name_)] = [
                    {"max_abs": largest(got, want)[0],
                     "over_atol_held": over(got, want, limit, held)}
                    for got, want in zip(got_steps, f64["steps"])]
            # the CPU against itself with the batch's rows permuted
            spread = record["cpu_rows_permuted"] = side["spread"]
            if any(spread["after_steps"][k - 1]["over_atol_held"]
                   for k in held_steps):
                raise AssertionError("the float32 check fails the CPU "
                                     "against itself: {}".format(spread))
            if flip is not None:
                # planted: one clamp decision replayed to the other bound
                _, tensor, step = flip
                caught = over(flip_steps[step - 1], cpu_steps[step - 1],
                              limit, held)
                record["planted_clamp_flip"] = {
                    "tensor": tensor, "step": step,
                    "over_atol": sum(caught.values())}
                if not caught:
                    raise AssertionError(
                        "the float32 check would pass a clamp decision "
                        "flipped in {} at step {}".format(tensor, step))
        else:
            for n in c.by_gradient:
                if f64["moved"][n] <= limit:
                    raise AssertionError("3 steps move {} by {}: the float64 "
                                         "check could not fail".format(
                                             n, f64["moved"][n]))
            if c.adam:
                record["planted_float64_bias_correction"] = {
                    "after_step": 3, "over_atol": f64["adam_planted"]}
                if not f64["adam_planted"]:
                    raise AssertionError(
                        "the float64 check would pass Adam with float64 "
                        "bias corrections")
    fields["cpu_seconds"] = {"float64": f64["seconds"],
                             "float32": f32["seconds"]}
    if failed:
        raise AssertionError("{} card vs CPU after 3 steps: {}".format(
            name, "; ".join(failed)))
    return fields


def _pack(obj, arrays):
    """``obj`` (dicts, lists, tuples, tensors and JSON scalars) as a JSON
    skeleton whose tensors are keys of ``arrays``."""
    import torch

    if torch.is_tensor(obj):
        key = "a{}".format(len(arrays))
        arrays[key] = obj.numpy()
        return {"array": key}
    if isinstance(obj, dict):
        return {"dict": [[k, _pack(v, arrays)] for k, v in obj.items()]}
    if isinstance(obj, (list, tuple)):
        return {"list": [_pack(v, arrays) for v in obj]}
    return {"value": obj}


def _unpack(skeleton, arrays):
    import torch

    if "array" in skeleton:
        return torch.from_numpy(arrays[skeleton["array"]])
    if "dict" in skeleton:
        return {k: _unpack(v, arrays) for k, v in skeleton["dict"]}
    if "list" in skeleton:
        return [_unpack(v, arrays) for v in skeleton["list"]]
    return skeleton["value"]


def save_side(path, obj):
    """A CPU side's results as an ``.npz`` (its structure in JSON)."""
    arrays = {}
    skeleton = _pack(obj, arrays)
    np.savez(path, skeleton=np.asarray(json.dumps(skeleton)), **arrays)
    return path


def load_side(path):
    with np.load(path) as z:
        arrays = {k: z[k] for k in z.files}
    return _unpack(json.loads(str(arrays.pop("skeleton"))), arrays)


def _cpu_worker_init(threads):
    import torch

    torch.set_num_threads(threads)


def _cpu_job(kind, name, out, workdir):
    """A CPU side in the worker, saved to ``out``: (out, busy seconds).
    ``kind`` "float64" or "float32" of network ``name`` (the latter reads
    the former's file under ``workdir``), or "similarity", the
    sub-cohort matrix of ``dtw_similarity``."""
    t0 = time.perf_counter()
    if kind == "float64":
        side = cpu_float64_side(name)
    elif kind == "float32":
        side = cpu_float32_side(name, load_side(os.path.join(
            workdir, "cpu_{}_float64.npz".format(name))))
    else:
        side = sub_cohort_similarity(tempfile.mkdtemp(dir=workdir), "cpu")
    save_side(out, side)
    return out, time.perf_counter() - t0


class WorkerSides(LocalSides):
    """One network's CPU sides read from the worker's results."""

    def __init__(self, worker, name):
        super().__init__(name)
        self.worker = worker

    def float64(self):
        if self._f64 is None:
            self._f64 = self.worker.result(self.name, "float64")
        return self._f64

    def float32(self):
        return self.worker.result(self.name, "float32")


class CpuSides:
    """The CPU sides of card-vs-CPU checks run in one worker process
    (spawned, ``threads`` torch threads) while the card runs its own sides
    and the phases before them.  ``jobs``: (kind, network) in the order
    to run, each network's "float64" pass before its "float32" pass (the
    card's runs of a network wait only for the former: its picks and
    clamp decisions), and ("similarity", None) for ``dtw_similarity``'s
    sub-cohort.  Each result comes back as an ``.npz`` under ``workdir``;
    a job that fails raises where its result is read."""

    def __init__(self, jobs, workdir, threads):
        import multiprocessing
        from concurrent.futures import ProcessPoolExecutor

        self.names = {name for _, name in jobs if name}
        self.pool = ProcessPoolExecutor(
            1, mp_context=multiprocessing.get_context("spawn"),
            initializer=_cpu_worker_init, initargs=(threads,))
        self.threads = threads
        self.jobs, self.busy, self.wait = {}, {}, {}
        for kind, name in jobs:
            out = os.path.join(workdir, "cpu_{}_{}.npz".format(name, kind))
            self.jobs[name, kind] = self.pool.submit(
                _cpu_job, kind, name, out, workdir)

    def result(self, name, kind):
        t0 = time.perf_counter()
        path, busy = self.jobs[name, kind].result()
        self.wait[name, kind] = time.perf_counter() - t0
        self.busy[name, kind] = busy
        return load_side(path)

    def sides(self, name):
        return WorkerSides(self, name)

    def report(self):
        return {"threads": self.threads, "jobs": len(self.jobs),
                "busy_s": sum(self.busy.values()),
                "wait_s": sum(self.wait.values()),
                "by_job": {"{} {}".format(*k): [self.busy[k], self.wait[k]]
                           for k in self.busy}}

    def close(self):
        self.pool.shutdown(wait=True, cancel_futures=True)


CPU_SIDES = None  # the worker's ``CpuSides`` in a whole run of main()
# LSTM kernel launches by path (network or phase) in a run of main()
LSTM_LAUNCHES = {}
# the paths whose networks hold an LSTM outside vmap: each must launch the
# LSTM kernels on the card
LSTM_PATHS = ("config4", "config4_unshuffled", "lstm_only",
              "lstm_only_with_packing", "double_lstm", "cnn_to_nested_lstm",
              "siamese_cnn_lstm", "siamese_pretrained_lstm")


def softmax_probs(logits):
    """Class probabilities of (n, 2) logits, or of (n, S, 2) per-breath
    logits as the mean of each window's S softmaxes (what the server and
    ``cli.predict`` answer)."""
    import torch

    probs = torch.softmax(torch.as_tensor(logits, dtype=torch.float64), -1)
    return (probs.mean(dim=1) if probs.ndim == 3 else probs).numpy()


def train_to_serve(trainer, models_dir, device, name="config1", fold=4):
    """Fold ``fold``'s checkpoint served: one /predict over HTTP, whose
    probabilities must be the trainer's final model's on the same
    normalized batch with the server's dropout seed, and the
    deterministic logits of the served model against the trainer's.  A
    nested network's request is one patient of NESTED_REAL windows, which
    the server pads to NESTED_BUCKET and masks."""
    import torch

    from deepards_tpu_torch.cli.serve import (
        DROPOUT_SEED,
        InferenceEngine,
        serve,
    )
    from deepards_tpu_torch.train import checkpoint as ckpt

    conf = trainer.conf
    path = os.path.join(models_dir, "{}-fold{}".format(name, fold))
    model = trainer.final_state.model
    layer = conf.get("siamese_time_layer")
    engine = InferenceEngine(path, network=conf.network,
                             base_network=conf.base_network,
                             n_sub_batches=conf.n_sub_batches,
                             batch_size=conf.batch_size,
                             scaling=ckpt.load_scaling(path),
                             bn_scope=getattr(model, "bn_scope", "sequence"),
                             device=device,
                             siamese_time_layer=layer or "none")
    engine.warm()
    nested = engine.super_batch
    n = NESTED_REAL if nested else conf.batch_size
    windows = make_windows(np.random.default_rng(SEED + 4), n,
                           conf.n_sub_batches)
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
    if probs.shape != (n, 2) or not np.isfinite(probs).all():
        raise AssertionError("bad served probabilities")
    x = torch.from_numpy(windows).to(engine.device)
    kwargs = {}
    if nested:
        x = torch.cat([x, x.new_zeros((NESTED_BUCKET - n,) + x.shape[1:])])
        x = x[None]
        kwargs["window_mask"] = torch.arange(
            NESTED_BUCKET, device=engine.device)[None] < n
    x = (x - engine._mu) / engine._std

    def logits(out):
        out = out[0] if isinstance(out, tuple) else out
        return out[0, :n] if nested else out

    with torch.no_grad():
        got = logits(engine.model(x, True, **kwargs))
        want = logits(model(x, True, **kwargs))
        served = logits(model(x, engine.deterministic, torch.Generator(
            device=engine.device).manual_seed(DROPOUT_SEED), **kwargs))
    err = float((got - want).abs().max())
    prob_err = float(np.abs(probs - softmax_probs(served.cpu())).max())
    if err > TRAIN_SERVE_ATOL or prob_err > TRAIN_SERVE_ATOL:
        raise AssertionError("served logits differ from the trainer's "
                             "model by {}, served probabilities by {}"
                             .format(err, prob_err))
    return {"checkpoint": os.path.basename(path), "max_abs_logit": err,
            "max_abs_served_prob": prob_err, "atol": TRAIN_SERVE_ATOL,
            "bn_scope": getattr(model, "bn_scope", None),
            "served_deterministic": engine.deterministic}


def random_cache(rng, n, conf):
    """A dataset stand-in over ``n`` random windows of config ``conf``'s
    (S, 1, 224) and targets."""
    from deepards_tpu_torch.data.windowing import WindowCache

    s = conf.n_sub_batches
    data = rng.normal(size=(n, s, C, L)).astype(np.float32)
    target = random_targets(rng, n, conf)
    return CacheView(WindowCache(
        data=data, target=target, hours=np.zeros((n, s), np.float32),
        patient_idx=np.zeros(n, np.int32), patients=["synthetic"]))


def config_fold(name, workdir, device, graphs, ds, dropout=True, *flags):
    """A ``Trainer`` of config ``name``'s flags (and ``flags``) with fold
    0's state built without a cohort, and a ``StepRunner`` of its steps
    over unit scaling for batches of ``ds`` (this rank's rows of them in
    a run over processes): CUDA-graph replays with ``graphs`` (the
    trainer's own choice on the card), else eager."""
    import torch

    from deepards_tpu_torch.data.pipeline import transform_batch
    from deepards_tpu_torch.train.loop import Trainer
    from deepards_tpu_torch.train.steps import StepRunner, make_train_step

    conf = config_conf(name, "--device", device, "--results-dir",
                       os.path.join(workdir, "measure"), *flags)
    trainer = Trainer(conf, verbose=False)
    trainer.n_sub_batches = ds.cache.data.shape[1]
    state = trainer.new_state(0)
    zero = torch.zeros(1, device=trainer.device)
    one = torch.ones(1, device=trainer.device)
    train_step, eval_step = make_train_step(
        trainer.loss_fn, transform=lambda d: transform_batch(d, zero, one),
        compute_dtype=trainer.compute_dtype, dropout_active=dropout,
        eval_dropout_active=dropout and not trainer.spec.eval_dropout_off,
        target_mode=trainer.spec.target_mode)
    runner = StepRunner(state, train_step, eval_step,
                        (trainer.batch_rows()[1],) + ds.cache.data.shape[1:],
                        target_width=ds.cache.target.shape[1],
                        graphed=graphs and trainer.device.type == "cuda",
                        axis=trainer.axis)
    return trainer, runner


def train_numbers(workdir, device, name="config1",
                  modes=(("eager", False), ("graphed", True)),
                  windows=MEASURE_WINDOWS, profile_reps=5, reps=20,
                  b2b_reps=3):
    """Step times, profile, memory and epoch rate of config ``name``'s
    step (full width, its batch, bf16, dropout on) on the device-cache
    path, over a cache of MEASURE_WINDOWS random windows built directly:
    the steps run eagerly (``eager``) and as CUDA-graph replays
    (``graphed``), as ``modes`` asks (``windows`` in place of
    MEASURE_WINDOWS; the profile over ``profile_reps`` steps; a step's time
    the median of ``reps``, its back-to-back time of ``b2b_reps`` runs of
    20; none with 0).  A step is the runner's train call
    over a batch already in its buffers; the epoch also gathers each batch
    on the card.  The build time and the peak memory cover the fold's
    state and the runner (the graphed one's warm-up, captures and
    pools)."""
    import torch

    conf = config_conf(name)
    batch = conf.batch_size
    out = {}
    for mode, graphs in modes:
        n = windows if graphs else min(windows, EAGER_MEASURE_WINDOWS)
        ds = random_cache(np.random.default_rng(SEED + 3), n, conf)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        baseline = torch.cuda.memory_allocated()
        t0 = time.perf_counter()
        trainer, runner = config_fold(name, workdir, device, graphs, ds)
        torch.cuda.synchronize()
        build_seconds = time.perf_counter() - t0
        dev = trainer._get_device_cache(ds)
        ids = torch.arange(batch, device=trainer.device)
        for key, table in dev.items():
            torch.index_select(table, 0, ids, out=runner.inputs[key])
        runner.inputs["mask"].fill_(1.0)
        train_ms = cuda_ms(runner.train, warmup=3, reps=reps)
        eval_ms = cuda_ms(runner.eval, warmup=3, reps=reps)
        # 20 steps queued back to back: the step-to-step time, which
        # the device bounds once the host queues faster than it runs
        train_b2b_ms = eval_b2b_ms = None
        if b2b_reps:
            train_b2b_ms = cuda_ms(
                lambda: [runner.train() for _ in range(20)], warmup=1,
                reps=b2b_reps) / 20
            eval_b2b_ms = cuda_ms(
                lambda: [runner.eval() for _ in range(20)], warmup=1,
                reps=b2b_reps) / 20
        train_profile = device_breakdown(runner.train, reps=profile_reps)
        eval_profile = device_breakdown(runner.eval, reps=profile_reps)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        trainer.run_train_epoch(runner, ds, 0, 1)
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        losses = trainer.results.get_meter("loss", 0).values
        if len(losses) != n // batch or not np.isfinite(losses).all():
            raise AssertionError("{} {} device-cache epoch: {} losses".format(
                name, mode, len(losses)))
        out[mode] = {
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
            "epoch_ms_per_step": seconds * 1e3 / (n // batch),
        }
        print("numbers {} {}: {} ms a step, {} ms on the device, idle {}, "
              "{} windows/s".format(
                  name, mode, train_ms, out[mode]["device_ms_per_step"],
                  out[mode]["device_idle_share"], n / seconds), flush=True)
        del runner, trainer
    out["compute_dtype"] = "bfloat16"
    out["batch"] = batch
    STEP_NUMBERS[name] = out
    return out


# graph_vs_eager: device-cache steps from one fold state (few, for the
# whole script's time: PERF.md §4)
GRAPH_STEPS = 2
GRAPH_ATOL = 1e-6


def graph_vs_eager(workdir, device="cuda", name="config1", steps=GRAPH_STEPS):
    """GRAPH_STEPS device-cache steps of config ``name`` from one fold
    state (a nested network: ``NESTED_GRAPH_PATIENTS``' patients, two
    buckets whose graphs share one pool), replayed as CUDA graphs and run
    eagerly, with cuDNN's deterministic algorithms (its default backward
    sums in another order from run to run), then an eval epoch over the
    same windows: float32 with dropout off, losses, every param and the
    eval outputs within GRAPH_ATOL; bfloat16 with dropout on, losses and
    eval outputs within GRAPH_ATOL and the dropout generator in the same
    state after the steps.  Returns (fields, failures)."""
    import torch

    from deepards_tpu_torch.models.registry import get_network_spec

    conf = config_conf(name)
    rng = np.random.default_rng(SEED + 6)
    spec = get_network_spec(conf.network)
    if spec.super_batch:
        run = nested_graph_run(workdir, device, name, rng)
        steps = len(NESTED_GRAPH_PATIENTS)
    elif spec.trainer == "siamese":
        run = siamese_graph_run(workdir, device, name, rng, steps)
    elif name in TWO_D_FLAGS:
        run = two_d_graph_run(workdir, device, name)
        steps = GRAPH_STEPS
    else:
        run = standard_graph_run(workdir, device, name, rng, steps)
    deterministic = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    fields = {"steps": steps, "atol": GRAPH_ATOL}
    failed = []
    try:
        for dtype, dropout in (("float32", False), ("bfloat16", True)):
            runs = {}
            for graphs in (False, True):
                losses, state, outs = run(graphs, dtype, dropout)
                runs[graphs] = (
                    losses.cpu(),
                    {k: v.detach().cpu()
                     for k, v in state.model.state_dict().items()},
                    state.generator.get_state(), state.step, outs.cpu())
            e_loss, e_params, e_rng, e_step, e_out = runs[False]
            g_loss, g_params, g_rng, g_step, g_out = runs[True]
            loss_err = float((g_loss - e_loss).abs().max())
            param_err = max(float((g_params[k] - e_params[k]).abs().max())
                            for k in e_params)
            out_err = float((g_out - e_out).abs().max())
            same_rng = bool(torch.equal(g_rng, e_rng))
            fields[dtype] = {
                "dropout": dropout, "losses_graphed": g_loss.tolist(),
                "losses_eager": e_loss.tolist(), "max_abs_loss": loss_err,
                "max_abs_params": param_err, "max_abs_eval_logits":
                out_err, "generator_state_equal": same_rng,
                "steps": [e_step, g_step]}
            if loss_err > GRAPH_ATOL or out_err > GRAPH_ATOL or (
                    not dropout and param_err > GRAPH_ATOL):
                failed.append("{}: loss {}, params {}, eval outputs {}"
                              .format(dtype, loss_err, param_err, out_err))
            if dropout and not same_rng:
                failed.append("{}: generator states differ".format(dtype))
            if e_step != g_step or not torch.isfinite(g_loss).all():
                failed.append("{}: steps {} / {}".format(dtype, e_step,
                                                          g_step))
    finally:
        torch.backends.cudnn.deterministic = deterministic
    return fields, failed


def standard_graph_run(workdir, device, name, rng, steps=GRAPH_STEPS):
    """``run(graphs, dtype, dropout)`` for ``graph_vs_eager``: ``steps``
    device-cache train steps of config ``name`` from fold 0's state, then
    an eval epoch over the same windows; (losses, state, eval outputs)."""
    from deepards_tpu_torch.train.loop import _epoch_order

    conf = config_conf(name)
    batch, s = conf.batch_size, conf.n_sub_batches
    ds = random_cache(rng, steps * batch, conf)
    ds.cache.data[:] = make_windows(rng, steps * batch, s)
    ids, masks = _epoch_order(rng.permutation(steps * batch), batch)
    masks[-1, -3:] = 0.0  # pad rows in the last batch

    def run(graphs, dtype, dropout):
        trainer, runner = config_fold(name, workdir, device, graphs, ds,
                                      dropout, "--compute-dtype", dtype)
        losses, _ = trainer._device_steps(runner, ds, ids, masks, True)
        # then an eval epoch over the same windows (dropout as in the
        # trainer's eval)
        _, outs = trainer._device_steps(runner, ds, ids, masks, False)
        return losses, runner.state, outs

    return run


# graph_vs_eager of a nested network: patients of these window counts
# (buckets 16 and 32, in turn), each trained on then evaluated
NESTED_GRAPH_PATIENTS = (12, 20, 9, 20)


def nested_fold(name, workdir, device, dtype, *flags):
    """A ``NestedTrainer`` of ``name``'s flags with fold 0's state built
    without a cohort (S windows of the config)."""
    from deepards_tpu_torch.train.nested_trainer import NestedTrainer

    conf = config_conf(name, "--device", device, "--results-dir",
                       os.path.join(workdir, "measure"), "--compute-dtype",
                       dtype, *flags)
    trainer = NestedTrainer(conf, verbose=False)
    trainer.n_sub_batches = conf.n_sub_batches
    return trainer, trainer.new_state(0)


def nested_runners(trainer, state, graphs, dropout=True):
    """The trainer's ``BucketRunners`` over unit scaling: CUDA-graph
    replays with ``graphs`` on the card, else eager."""
    import torch

    from deepards_tpu_torch.data.pipeline import transform_batch

    zero = torch.zeros(1, device=trainer.device)
    one = torch.ones(1, device=trainer.device)
    return trainer.nested_runners(
        state, lambda d: transform_batch(d, zero, one),
        (trainer.n_sub_batches, C, L),
        graphs and trainer.device.type == "cuda", dropout)


def nested_graph_run(workdir, device, name, rng):
    """``run(graphs, dtype, dropout)`` for ``graph_vs_eager``: a train
    step per patient of NESTED_GRAPH_PATIENTS from fold 0's state, then an
    eval of each; (losses, state, eval logits)."""
    import torch

    conf = config_conf(name)
    n = sum(NESTED_GRAPH_PATIENTS)
    ds = random_cache(rng, n, conf)
    ds.cache.data[:] = make_windows(rng, n, conf.n_sub_batches)
    bounds = np.cumsum((0,) + NESTED_GRAPH_PATIENTS)
    groups = [(str(k), np.arange(lo, hi), k % 2)
              for k, (lo, hi) in enumerate(zip(bounds[:-1], bounds[1:]))]

    def run(graphs, dtype, dropout):
        trainer, state = nested_fold(name, workdir, device, dtype)
        runners = nested_runners(trainer, state, graphs, dropout)
        losses, _ = trainer.patient_steps(runners, ds, groups, True)
        _, outs = trainer.patient_steps(runners, ds, groups, False)
        return losses, state, torch.cat(outs)

    return run


def phase_graph_vs_eager(workdir, device="cuda"):
    """``graph_vs_eager`` of config 1."""
    fields, failed = graph_vs_eager(workdir, device)
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
            base, path("surface_models", "surface-fold0"), path("surface"))
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


def predict_vs_eval(base, checkpoint, prefix):
    """``cli.predict`` on ``checkpoint`` (training flags ``base``) against
    the trainer's eval of the same checkpoint: the same windows, and
    probabilities within PREDICT_ATOL (a per-breath head's as the mean of
    its windows' softmaxes); for a per-window head also the same votes.
    ``prefix``: where its outputs go."""
    from deepards_tpu_torch.cli.predict import main as predict_main
    from deepards_tpu_torch.cli.train import main as train_main

    t0 = time.perf_counter()
    rows, votes = predict_main([
        "--checkpoint", checkpoint, "-o", prefix + "_predictions.csv",
        "--votes-output", prefix + "_votes.json"] + base)
    seconds = time.perf_counter() - t0
    evaluated = train_main(base + [
        "--results-dir", prefix + "_eval_results", "--load-checkpoint",
        checkpoint, "--no-train", "--epochs", "1"])
    logits = evaluated.last_eval["logits"]
    want = softmax_probs(logits)
    got = np.array([[r["prob_other"], r["prob_ards"]] for r in rows])
    if [r["window_index"] for r in rows] != \
            evaluated.last_eval["index"].tolist():
        raise AssertionError("predict and the eval visit other windows")
    err = float(np.abs(got - want).max())
    votes_equal = None
    if logits.ndim == 2:  # per-breath votes count S predictions a window
        records = {r["patient"]: r for r in evaluated.results.results}
        votes_equal = len(records) == len(votes) and all(
            v["pred_frac"] == records[v["patient"]]["pred_frac"]
            and (v["pred_frac"] == 0.5
                 or v["prediction"] == records[v["patient"]]["prediction"])
            for v in votes)
    if err > PREDICT_ATOL or votes_equal is False or not os.path.exists(
            prefix + "_predictions.csv"):
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
    trainer, models_dir, run = train_config(workdir, device)
    fields = {"card": smi, "config1": run,
              "card_vs_cpu": train_card_vs_cpu(device),
              "train_to_serve": train_to_serve(trainer, models_dir, device),
              "cudnn_allow_tf32": torch.backends.cudnn.allow_tf32,
              "matmul_allow_tf32": torch.backends.cuda.matmul.allow_tf32}
    if device == "cuda":
        fields["numbers"] = train_numbers(workdir, device)
    fields["train_phase_seconds"] = time.perf_counter() - t0
    emit("train", **fields)


def phase_config(workdir, name, device="cuda"):
    """Benchmark config ``name`` (2, 3 or 4) on the device: trained
    through the CLI (every fold, TRAIN_EPOCHS epochs), 3 float32 steps at
    full width held against the CPU (and in float64), GRAPH_STEPS graphed
    device-cache steps held to eager ones, for a classifier a trained
    checkpoint served and ``cli.predict`` on one, both held to the
    trainer's model and eval, and the bf16 graphed step timed over a
    MEASURE_WINDOWS-window device cache."""
    t0 = time.perf_counter()
    trainer, models_dir, run = train_config(workdir, device, name)
    fields = {"card": nvidia_smi_line() if device == "cuda" else None,
              "flags": CONFIG_FLAGS[name], "run": run,
              "card_vs_cpu": train_card_vs_cpu(device, name)}
    fields["graph_vs_eager"], failed = graph_vs_eager(workdir, device, name)
    if trainer.spec.kind == "classifier":
        fields["train_to_serve"] = train_to_serve(trainer, models_dir,
                                                  device, name)
        cohort_dir, cohort = config_cohort(workdir, trainer.conf)
        fields["predict"] = predict_vs_eval(
            CONFIG_FLAGS[name] + [
                "--data-path", cohort_dir, "--cohort-file", cohort,
                "--only-fold", "0", "--device", device],
            os.path.join(models_dir, name + "-fold0"),
            os.path.join(workdir, name))
    if device == "cuda":
        fields["numbers"] = train_numbers(workdir, device, name,
                                          modes=(("graphed", True),))
    fields["phase_seconds"] = time.perf_counter() - t0
    emit(name, **fields)
    if failed:
        raise AssertionError("{} graphed vs eager: {}".format(
            name, "; ".join(failed)))


def elements_over(got, want, names, limit):
    """Per tensor of ``names``, the count of elements of ``got`` more than
    ``limit`` from ``want``; tensors with none left out."""
    counts = {}
    for n in names:
        bad = int(((got[n] - want[n]).abs() > limit).sum())
        if bad:
            counts[n] = bad
    return counts


def snapshot(tensors):
    """float64 CPU copies of a mapping of tensors."""
    import torch

    return {n: v.detach().to("cpu", torch.float64, copy=True)
            for n, v in tensors.items()}


def step_profile(fn, reps=20, b2b_reps=3, profile_reps=5):
    """A step's time (CUDA events, the median of ``reps``), its
    back-to-back time over 20 queued calls (``b2b_reps`` runs), device
    time, kernels and idle share (a profile of ``profile_reps`` calls)."""
    ms = cuda_ms(fn, warmup=3, reps=reps)
    b2b = cuda_ms(lambda: [fn() for _ in range(20)], warmup=1,
                  reps=b2b_reps) / 20
    prof = device_breakdown(fn, reps=profile_reps)
    return {"ms": ms, "back_to_back_ms": b2b,
            "device_ms": prof["device_ms_per_call"],
            "launches": prof["kernel_launches_per_call"],
            "host_dispatches": prof["host_dispatches_per_call"],
            "device_idle_share": 1.0 - prof["device_ms_per_call"] / ms,
            "top": prof["top"][:4]}


# -- config 4 with --unshuffled: the stateful fold ---------------------------

# card vs CPU: three windows, the first two of one patient (the carry
# goes on), the third of the next (the carry is reset)
STATEFUL_RESETS = (1.0, 0.0, 1.0)


def stateful_card_vs_cpu(device):
    """Three stateful train steps of config 4's cnn_lstm at full width,
    one window each, dropout off, the carry taken across the first
    boundary and reset at the second, on the device and on the CPU from the
    same params, in float32 and float64: the losses within 1e-4, the carry
    and every param element within 1e-5 after each step (in float32 the
    first conv held by float64, as ``TRAIN_STEP_ATOL`` says).  Planted
    faults each check must fail: the head's bias left at its init; the CPU
    run with no reset at the patient change (its carry and its last loss
    must part from the card's)."""
    import torch

    from deepards_tpu_torch.data.pipeline import transform_batch
    from deepards_tpu_torch.train.loop import Trainer, make_stateful_steps
    from deepards_tpu_torch.train.steps import TrainState, make_optimizer

    conf = config_conf("config4_unshuffled", "--device", "cpu")
    s = conf.n_sub_batches
    rng = np.random.default_rng(SEED + 9)
    raw = make_windows(rng, 3, s)
    mu, std = np.float32([raw.mean()]), np.float32([raw.std()])
    targets = np.eye(2, dtype=np.float32)[[1, 1, 0]]
    trainer = Trainer(conf, verbose=False)
    trainer.n_sub_batches = s
    init = trainer.build_model().reset_parameters(
        torch.Generator().manual_seed(SEED)).state_dict()
    names = list(init)
    head_bias = "head.bias"
    by_gradient = [n for n in names if n.startswith(BY_GRADIENT["config4"])]
    limit = TRAIN_STEP_ATOL["params"]

    def run(dev, dtype, resets=STATEFUL_RESETS):
        model = trainer.build_model()
        model.load_state_dict(init)
        model.to(device=dev, dtype=dtype)
        optimizer = make_optimizer(
            model.parameters(), conf.optimizer,
            learning_rate=conf.learning_rate,
            weight_decay=conf.weight_decay,
            clip_grad=bool(conf.get("clip_grad")), clip_val=conf.clip_val)
        state = TrainState(model, optimizer, torch.Generator(device=dev))
        mu_d, std_d = (torch.from_numpy(a).to(dev, dtype) for a in (mu, std))
        step, _ = make_stateful_steps(
            trainer.loss_fn,
            transform=lambda d: transform_batch(d, mu_d, std_d),
            dropout_active=False)
        carry = [torch.zeros(1, model.lstm.hidden_size, device=dev,
                             dtype=dtype) for _ in range(2)]
        mask = torch.ones(1, device=dev, dtype=dtype)
        losses, params, carries = [], [], []
        for k in range(3):
            x, t = (torch.from_numpy(a[k:k + 1]).to(dev, dtype)
                    for a in (raw, targets))
            reset = torch.tensor([resets[k]], device=dev, dtype=dtype)
            losses.append(float(step(state, x, t, mask, carry[0], carry[1],
                                     reset)))
            params.append(snapshot(model.state_dict()))
            carries.append(snapshot({"c": carry[0], "h": carry[1]}))
        return losses, params, carries

    fields = {"atol": TRAIN_STEP_ATOL, "resets": STATEFUL_RESETS}
    failed = []
    for dtype_name, dtype in (("float32", torch.float32),
                              ("float64", torch.float64)):
        f32 = dtype == torch.float32
        cpu_losses, cpu_params, cpu_carries = run("cpu", dtype)
        dev_losses, dev_params, dev_carries = run(device, dtype)
        held = [n for n in names if not (f32 and n in by_gradient)]
        loss_err = float(np.max(np.abs(np.subtract(dev_losses, cpu_losses))))
        record = fields[dtype_name] = {
            "losses_device": dev_losses, "losses_cpu": cpu_losses,
            "max_abs_loss": loss_err}
        if loss_err > TRAIN_STEP_ATOL["loss"]:
            failed.append("{} loss {}".format(dtype_name, loss_err))
        for k in range(3):
            over = elements_over(dev_params[k], cpu_params[k], held, limit)
            carry_err = max(float((dev_carries[k][n] - cpu_carries[k][n])
                                  .abs().max()) for n in ("c", "h"))
            record["after_step_{}".format(k + 1)] = {
                "over_atol_held": over, "max_abs_carry": carry_err,
                "max_abs_params": max(
                    float((dev_params[k][n] - cpu_params[k][n]).abs().max())
                    for n in names)}
            if over or carry_err > limit:
                failed.append("{} after step {}: params over {}: {}, carry "
                              "{}".format(dtype_name, k + 1, limit, over,
                                          carry_err))
        planted = dict(dev_params[-1])
        planted[head_bias] = init[head_bias].double()
        caught = elements_over(planted, cpu_params[-1], held, limit)
        _, _, unreset = run("cpu", dtype, resets=(1.0, 0.0, 0.0))
        unreset_err = max(float((dev_carries[-1][n] - unreset[-1][n])
                                .abs().max()) for n in ("c", "h"))
        record["planted"] = {"head_bias_not_updated_over_atol":
                             sum(caught.values()),
                             "no_reset_at_patient_change_max_abs_carry":
                             unreset_err}
        if not caught or unreset_err <= limit:
            raise AssertionError("the stateful {} check would pass a planted "
                                 "fault: {}".format(dtype_name,
                                                    record["planted"]))
        if not f32:
            for n in by_gradient:
                moved = float((cpu_params[-1][n] - init[n].double())
                              .abs().max())
                if moved <= limit:
                    raise AssertionError("3 steps move {} by {}: the float64 "
                                         "check could not fail".format(
                                             n, moved))
    if failed:
        raise AssertionError("config4 --unshuffled card vs CPU: "
                             + "; ".join(failed))
    return fields


def stateful_graph_vs_eager(workdir, device):
    """A train and a test epoch of the stateful fold over 8 windows of
    two patients (full width), graphed and eager from one fold state:
    float32 with dropout off, losses, params and eval logits within
    GRAPH_ATOL; bfloat16 with dropout on, losses within GRAPH_ATOL and the
    generators equal.  Returns (fields, failures, the graphed bf16 runner
    for timing)."""
    import torch

    from deepards_tpu_torch.train.loop import Trainer

    rng = np.random.default_rng(SEED + 10)
    ds = cohort_dataset(workdir, make_windows(rng, 8), [1, 0], 4)
    fields = {"windows": 8, "patients": 2, "atol": GRAPH_ATOL}
    failed = []
    timed = None
    deterministic = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    try:
        for dtype, dropout in (("float32", False), ("bfloat16", True)):
            runs = {}
            for graphs in (False, True):
                conf = config_conf("config4_unshuffled", "--device", device,
                                   "--compute-dtype", dtype, "--results-dir",
                                   os.path.join(workdir, "stateful_g"))
                trainer = Trainer(conf, verbose=False)
                trainer.n_sub_batches = S
                state = trainer.new_state(0)
                runner = trainer.make_stateful_runner(
                    state, ds, dropout=dropout,
                    graphed=graphs and trainer.device.type == "cuda")
                trainer.run_stateful_epoch(runner, ds, True, 0, 1)
                trainer.run_stateful_epoch(runner, ds, False, 0, 1)
                res = trainer.results
                runs[graphs] = (
                    np.asarray(res.get_meter("loss", 0).values),
                    np.asarray(res.get_meter("test_loss", 0).values),
                    snapshot(state.model.state_dict()),
                    trainer.last_eval["logits"], state.generator.get_state())
                if graphs and dropout:
                    timed = runner
            (e_loss, e_test, e_params, e_out, e_rng) = runs[False]
            (g_loss, g_test, g_params, g_out, g_rng) = runs[True]
            loss_err = float(max(np.abs(g_loss - e_loss).max(),
                                 np.abs(g_test - e_test).max()))
            param_err = max(float((g_params[k] - e_params[k]).abs().max())
                            for k in e_params)
            out_err = float(np.abs(g_out - e_out).max())
            same_rng = bool(torch.equal(g_rng, e_rng))
            fields[dtype] = {"dropout": dropout, "max_abs_loss": loss_err,
                             "max_abs_params": param_err,
                             "max_abs_eval_logits": out_err,
                             "generator_state_equal": same_rng,
                             "steps": len(g_loss)}
            if loss_err > GRAPH_ATOL or (not dropout and (
                    param_err > GRAPH_ATOL or out_err > GRAPH_ATOL)) or (
                    dropout and not same_rng) or len(g_loss) != 8:
                failed.append("{}: {}".format(dtype, fields[dtype]))
    finally:
        torch.backends.cudnn.deterministic = deterministic
    return fields, failed, timed


def phase_config4_unshuffled(workdir, device="cuda"):
    """Config 4 with ``--unshuffled`` on the device: trained through the
    CLI (every fold, TRAIN_EPOCHS epochs), 3 full-width stateful steps
    held against the CPU, graphed epochs held to eager ones, and the bf16
    graphed step of one window timed."""
    t0 = time.perf_counter()
    trainer, _, run = train_config(workdir, device, "config4_unshuffled")
    fields = {"card": nvidia_smi_line() if device == "cuda" else None,
              "flags": CONFIG_FLAGS["config4_unshuffled"], "run": run,
              "eval_logits_shape": list(trainer.last_eval["logits"].shape),
              "card_vs_cpu": stateful_card_vs_cpu(device)}
    fields["graph_vs_eager"], failed, runner = stateful_graph_vs_eager(
        workdir, device)
    if device == "cuda":
        fields["numbers"] = {"batch": 1, "compute_dtype": "bfloat16",
                             "step": step_profile(runner.train),
                             "eval": step_profile(runner.eval)}
        step = fields["numbers"]["step"]
        step["windows_per_s"] = 1e3 / step["back_to_back_ms"]
        print("numbers config4_unshuffled: {} ms a step, {} ms on the "
              "device, {} kernels".format(step["ms"], step["device_ms"],
                                          step["launches"]), flush=True)
    fields["phase_seconds"] = time.perf_counter() - t0
    emit("config4_unshuffled", **fields)
    if failed:
        raise AssertionError("config4 --unshuffled graphed vs eager: "
                             + "; ".join(failed))


# -- config 7: --parallel-folds ----------------------------------------------

PARALLEL_FOLDS = 5
FOLD_SLICE_ATOL = 1e-6  # a fold's slice of a stacked step vs its own step


def stacked_trainer(name, workdir, device, ds, splits, dtype="bfloat16",
                    dropout=True, graphed=True):
    """A ``ParallelFoldTrainer`` of config ``name``'s flags with the
    stacked state of len(splits) folds (unit scaling) and its runner over
    batches of ``ds``, built without a cohort."""
    from deepards_tpu_torch.train.parallel_folds import ParallelFoldTrainer

    conf = config_conf(name, "--device", device, "--compute-dtype", dtype,
                       "--results-dir", os.path.join(workdir, "stacked"))
    trainer = ParallelFoldTrainer(conf, verbose=False)
    trainer.n_sub_batches = ds.cache.data.shape[1]
    trainer.fold_train_idx = trainer.fold_test_idx = list(splits)
    unit = (np.zeros(C, np.float32), np.ones(C, np.float32))
    trainer.scaling = [unit] * len(splits)
    state = trainer.new_stacked_state(len(splits))
    runner = trainer.make_stacked_runner(
        state, ds, dropout=dropout,
        graphed=graphed and trainer.device.type == "cuda")
    return trainer, runner


def stacked_card_vs_cpu(device):
    """Three stacked steps of config 7 (5 folds of config 1's network at
    full width and batch, dropout off, each fold its own init, scaling
    and batches, one pad row a fold) on the device and on the CPU, in
    float32 and float64: the (5,) losses within 1e-4 and every element of
    the stacked params within 1e-5 after each step (in float32 the first
    conv held by float64).  Then each fold's slice of one stacked step on
    the device against that fold's own sequential step there
    (``make_train_step``, the same params, batch and scaling): losses and
    params within FOLD_SLICE_ATOL, in float32 (the first conv held by
    float64) and float64.  Planted: the head's bias left at its init;
    fold 0's slice against fold 1's step."""
    import torch

    from deepards_tpu_torch.data.pipeline import transform_batch
    from deepards_tpu_torch.train.loop import Trainer
    from deepards_tpu_torch.train.parallel_folds import (
        StackedParams,
        make_fold_steps,
    )
    from deepards_tpu_torch.train.steps import (
        TrainState,
        make_optimizer,
        make_train_step,
    )

    conf = config_conf("config7", "--device", "cpu")
    folds, s, batch = PARALLEL_FOLDS, conf.n_sub_batches, conf.batch_size
    rng = np.random.default_rng(SEED + 11)
    raw = make_windows(rng, 3 * folds * batch, s).reshape(
        (3, folds, batch, s, C, L))
    targets = np.eye(2, dtype=np.float32)[rng.integers(
        0, 2, (3, folds, batch))]
    masks = np.ones((3, folds, batch), np.float32)
    masks[:, :, -1] = 0.0
    mus = np.stack([[raw[:, f].mean()] for f in range(folds)]).astype(
        np.float32)
    stds = np.stack([[raw[:, f].std()] for f in range(folds)]).astype(
        np.float32)
    trainer = Trainer(conf, verbose=False)
    trainer.n_sub_batches = s
    inits = [trainer.build_model().reset_parameters(
        torch.Generator().manual_seed(SEED + f)).state_dict()
        for f in range(folds)]
    names = list(inits[0])
    limit = TRAIN_STEP_ATOL["params"]
    by_gradient = [n for n in names if n.startswith(BY_GRADIENT["config7"])]
    opt_kw = dict(learning_rate=conf.learning_rate,
                  weight_decay=conf.weight_decay,
                  clip_grad=bool(conf.get("clip_grad")),
                  clip_val=conf.clip_val)

    def on(dev, dtype, *arrays):
        return [torch.from_numpy(np.ascontiguousarray(a)).to(dev, dtype)
                for a in arrays]

    def stacked_run(dev, dtype, steps=3):
        params = StackedParams(names, [torch.stack([i[n] for i in inits])
                                       for n in names]).to(dev, dtype)
        template = trainer.build_model().to(dev, dtype)
        state = TrainState(params, make_optimizer(
            params.parameters(), conf.optimizer, **opt_kw),
            torch.Generator(device=dev))
        mu_d, std_d = on(dev, dtype, mus, stds)
        step, _ = make_fold_steps(template, trainer.loss_fn, mu_d, std_d,
                                  dropout_active=False)
        losses, snaps = [], []
        for k in range(steps):
            losses.append(step(state, *on(dev, dtype, raw[k], targets[k],
                                          masks[k])).cpu().double().numpy())
            snaps.append(snapshot(params.as_dict()))
        return np.stack(losses), snaps

    def fold_run(f, dev, dtype):
        model = trainer.build_model()
        model.load_state_dict(inits[f])
        model.to(dev, dtype)
        state = TrainState(model, make_optimizer(
            model.parameters(), conf.optimizer, **opt_kw),
            torch.Generator(device=dev))
        mu_d, std_d = on(dev, dtype, mus[f], stds[f])
        step, _ = make_train_step(
            trainer.loss_fn,
            transform=lambda d: transform_batch(d, mu_d, std_d),
            dropout_active=False)
        loss = float(step(state, *on(dev, dtype, raw[0, f], targets[0, f],
                                     masks[0, f])))
        return loss, snapshot(model.state_dict())

    fields = {"folds": folds, "batch": batch, "atol": TRAIN_STEP_ATOL}
    failed = []
    for dtype_name, dtype in (("float32", torch.float32),
                              ("float64", torch.float64)):
        f32 = dtype == torch.float32
        cpu_losses, cpu_params = stacked_run("cpu", dtype)
        dev_losses, dev_params = stacked_run(device, dtype)
        held = [n for n in names if not (f32 and n in by_gradient)]
        loss_err = float(np.abs(dev_losses - cpu_losses).max())
        record = fields[dtype_name] = {"max_abs_loss": loss_err,
                                       "losses_device": dev_losses.tolist()}
        if loss_err > TRAIN_STEP_ATOL["loss"]:
            failed.append("{} loss {}".format(dtype_name, loss_err))
        for k in range(3):
            over = elements_over(dev_params[k], cpu_params[k], held, limit)
            record["after_step_{}".format(k + 1)] = {
                "over_atol_held": over,
                "max_abs_params": max(float((dev_params[k][n]
                                             - cpu_params[k][n]).abs().max())
                                      for n in names)}
            if over:
                failed.append("{} after step {}: {}".format(dtype_name,
                                                            k + 1, over))
        planted = dict(dev_params[-1])
        planted["head.bias"] = torch.stack(
            [i["head.bias"] for i in inits]).double()
        caught = elements_over(planted, cpu_params[-1], held, limit)
        record["planted_head_bias_not_updated"] = sum(caught.values())
        if not caught:
            raise AssertionError("the stacked {} check would pass the head's "
                                 "bias left at its init".format(dtype_name))
    # each fold's slice of one stacked step against the fold's own
    # sequential step, on the device; in float32 the first conv (whose
    # gradient sums cancel, BY_GRADIENT) held by the float64 run
    record = fields["fold_slice_vs_sequential"] = {"atol": FOLD_SLICE_ATOL}
    for dtype_name, dtype in (("float32", torch.float32),
                              ("float64", torch.float64)):
        held = [n for n in names if not (dtype == torch.float32
                                         and n in by_gradient)]
        one_losses, one_params = stacked_run(device, dtype, steps=1)
        slices = []
        for f in range(folds):
            loss, params = fold_run(f, device, dtype)
            slices.append(max([abs(loss - float(one_losses[0, f]))] + [
                float((one_params[0][n][f] - params[n]).abs().max())
                for n in held]))
            if f == 0:
                _, other = fold_run(1, device, dtype)
                planted = max(float((one_params[0][n][0] - other[n])
                                    .abs().max()) for n in held)
                if planted <= FOLD_SLICE_ATOL:
                    raise AssertionError("the fold-slice check would pass "
                                         "fold 1's step for fold 0's")
        record[dtype_name] = {
            "max_abs_by_fold": slices, "planted_other_fold": planted,
            "first_conv_max_abs_last_fold": max(
                float((one_params[0][n][f] - params[n]).abs().max())
                for n in by_gradient)}
        if max(slices) > FOLD_SLICE_ATOL:
            failed.append("{} fold slices vs sequential steps: {}".format(
                dtype_name, slices))
    if failed:
        raise AssertionError("config7 card vs CPU: " + "; ".join(failed))
    return fields


def stacked_graph_vs_eager(workdir, device):
    """GRAPH_STEPS stacked steps of config 7 and an eval epoch, graphed
    and eager from one state, as ``graph_vs_eager`` holds the sequential
    steps.  Returns (fields, failures)."""
    import torch

    rng = np.random.default_rng(SEED + 12)
    conf = config_conf("config7")
    batch = conf.batch_size
    n = GRAPH_STEPS * batch
    ds = random_cache(rng, PARALLEL_FOLDS * n, conf)
    ds.cache.data[:] = make_windows(rng, PARALLEL_FOLDS * n, S)
    splits = np.arange(PARALLEL_FOLDS * n).reshape(PARALLEL_FOLDS, n)
    ids = np.stack([rng.permutation(split).reshape(GRAPH_STEPS, batch)
                    for split in splits], axis=1)
    masks = np.ones(ids.shape, np.float32)
    masks[-1, :, -3:] = 0.0
    fields = {"steps": GRAPH_STEPS, "folds": PARALLEL_FOLDS,
              "atol": GRAPH_ATOL}
    failed = []
    deterministic = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    try:
        for dtype, dropout in (("float32", False), ("bfloat16", True)):
            runs = {}
            for graphs in (False, True):
                trainer, runner = stacked_trainer(
                    "config7", workdir, device, ds, splits, dtype, dropout,
                    graphs)
                losses, _ = trainer.stacked_steps(runner, ds, ids, masks,
                                                  True)
                _, outs = trainer.stacked_steps(runner, ds, ids, masks,
                                                False)
                runs[graphs] = (losses.cpu(), snapshot(
                    runner.state.model.as_dict()), outs.cpu(),
                    runner.state.generator.get_state())
            e_loss, e_params, e_out, e_rng = runs[False]
            g_loss, g_params, g_out, g_rng = runs[True]
            loss_err = float((g_loss - e_loss).abs().max())
            param_err = max(float((g_params[k] - e_params[k]).abs().max())
                            for k in e_params)
            out_err = float((g_out - e_out).abs().max())
            same_rng = bool(torch.equal(g_rng, e_rng))
            fields[dtype] = {"dropout": dropout, "max_abs_loss": loss_err,
                             "max_abs_params": param_err,
                             "max_abs_eval_logits": out_err,
                             "generator_state_equal": same_rng}
            if loss_err > GRAPH_ATOL or out_err > GRAPH_ATOL or (
                    not dropout and param_err > GRAPH_ATOL) or (
                    dropout and not same_rng):
                failed.append("{}: {}".format(dtype, fields[dtype]))
    finally:
        torch.backends.cudnn.deterministic = deterministic
    return fields, failed


def stacked_numbers(workdir, device, name):
    """The bf16 graphed stacked step of config ``name``'s network over 5
    folds (dropout on) on a MEASURE_WINDOWS-window device cache split 5
    ways: step time, device time, kernels, idle share, and an epoch of all
    folds (windows/s over all folds), beside 5 times the sequential
    step this run measured for the config."""
    import torch

    conf = config_conf(name)
    batch = conf.batch_size
    ds = random_cache(np.random.default_rng(SEED + 13), MEASURE_WINDOWS,
                      conf)
    splits = np.array_split(np.arange(MEASURE_WINDOWS), PARALLEL_FOLDS)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    trainer, runner = stacked_trainer(name, workdir, device, ds, splits)
    ids = np.stack([split[:batch] for split in splits])[None]
    trainer.stacked_steps(runner, ds, ids, np.ones(ids.shape, np.float32),
                          True)
    step = step_profile(runner.train)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    trainer.run_stacked_train_epoch(runner, ds, 1)
    trainer._flush_deferred()
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    steps = len(trainer.results.get_meter("loss", 0).values)
    windows = steps * batch * PARALLEL_FOLDS
    sequential = STEP_NUMBERS.get(name, {}).get("graphed", {})
    out = {"folds": PARALLEL_FOLDS, "batch": batch, "compute_dtype":
           "bfloat16", "step": step, "epoch_steps": steps,
           "epoch_seconds": seconds, "windows_per_s": windows / seconds,
           "step_windows_per_s": PARALLEL_FOLDS * batch * 1e3
           / step["back_to_back_ms"],
           "peak_memory_bytes": torch.cuda.max_memory_allocated()}
    if sequential:
        out["sequential"] = {
            "step_ms": sequential["train_step_ms"],
            "five_steps_ms": PARALLEL_FOLDS * sequential["train_step_ms"],
            "launches_per_step": sequential["launches_per_step"],
            "windows_per_s": sequential["windows_per_s"]}
        out["speedup_vs_5_sequential_steps"] = (
            PARALLEL_FOLDS * sequential["train_step_ms"] / step["ms"])
    print("numbers {} x{} folds: {} ms a stacked step, {} ms on the device, "
          "{} kernels, {} windows/s".format(
              name, PARALLEL_FOLDS, step["ms"], step["device_ms"],
              step["launches"], out["windows_per_s"]), flush=True)
    return out


def phase_config7(workdir, device="cuda"):
    """Config 1's folds trained at once (``--parallel-folds``, the JAX
    benchmark's config 7): the CLI run, 3 stacked steps card vs CPU and
    each fold's slice vs its own sequential step, graphed vs eager, a
    fold's checkpoint through ``cli.predict`` against the trainer's eval,
    and the timed bf16 stacked step of densenet18 and of resnet18 (config
    2's network, the JAX benchmark's vmapped config 2)."""
    t0 = time.perf_counter()
    trainer, models_dir, run = train_config(workdir, device, "config7")
    fields = {"card": nvidia_smi_line() if device == "cuda" else None,
              "flags": CONFIG_FLAGS["config7"], "run": run,
              "card_vs_cpu": stacked_card_vs_cpu(device)}
    fields["graph_vs_eager"], failed = stacked_graph_vs_eager(workdir,
                                                              device)
    cohort_dir, cohort = config_cohort(workdir, trainer.conf)
    fields["predict"] = predict_vs_eval(
        CONFIG1_FLAGS + ["--data-path", cohort_dir, "--cohort-file", cohort,
                         "--only-fold", "0", "--device", device],
        os.path.join(models_dir, "config7-fold0"),
        os.path.join(workdir, "config7"))
    if device == "cuda":
        fields["numbers"] = {
            "config1_parallel": stacked_numbers(workdir, device, "config1"),
            "config2_parallel": stacked_numbers(workdir, device, "config2")}
    fields["phase_seconds"] = time.perf_counter() - t0
    emit("config7", **fields)
    if failed:
        raise AssertionError("config7 graphed vs eager: " + "; ".join(failed))


# -- config 5: ProtoPNet and GradCAM -----------------------------------------

# the push, card vs CPU: prototype vectors (sigmoid outputs) within 1e-5;
# distances, sums of 128 squares near 10 less a cross term, within 1e-5
# of their size (float32 rounds terms of ~40 to 4e-6)
PUSH_ATOL = 1e-5
# a stage's params after one float64 step, card vs CPU: the last layer
# moves ~1e-6 in a step at lr 1e-3, under TRAIN_STEP_ATOL's 1e-5, so only
# a float64 limit can see it left at its init
STAGE_F64_ATOL = 1e-10
CAM_SEQUENCES = 128  # the JAX benchmark's cam pass (bench.py:951-979)
CAM_ATOL = 1e-5


def ppnet_trainer(device, *flags, name="config5"):
    from deepards_tpu_torch.train.protopnet_trainer import ProtoPNetTrainer

    conf = config_conf(name, "--device", device, *flags)
    trainer = ProtoPNetTrainer(conf, verbose=False)
    trainer.n_sub_batches = conf.n_sub_batches
    return trainer


def ppnet_card_vs_cpu(device, name="config5"):
    """One full-width step of each stage of config 5, or of protopnet_2d
    over normalized images (batch 16, one pad
    row, dropout off) on the device and on the CPU from the same params,
    in float32 and float64: the loss within 1e-4, the stage's params
    within 1e-5 in float32 (the first conv held by float64) and
    STAGE_F64_ATOL in float64, and every param outside the stage
    bit-equal to its init on both sides.  Planted: the stage's most moved
    param left at its init, which the float64 check of every stage and the
    float32 check of a stage that moves it more than 1e-5 must fail; a
    param outside the stage moved by 1e-6."""
    import torch

    from deepards_tpu_torch.data.pipeline import transform_batch
    from deepards_tpu_torch.train.protopnet_trainer import (
        STAGES,
        make_ppnet_steps,
        stage_groups,
    )
    from deepards_tpu_torch.train.steps import TrainState, make_optimizer

    two_d = name in TWO_D_FLAGS
    trainer = two_d_trainer(name, "cpu") if two_d else ppnet_trainer("cpu")
    conf = trainer.conf
    rng = np.random.default_rng(SEED + 14)
    if two_d:
        raw = rng.normal(size=(conf.batch_size, trainer.in_channels,
                               IMAGE, IMAGE)).astype(np.float32)
    else:
        raw = make_windows(rng, conf.batch_size, conf.n_sub_batches)
    mu, std = np.float32([raw.mean()]), np.float32([raw.std()])
    targets = np.eye(2, dtype=np.float32)[rng.integers(0, 2,
                                                       conf.batch_size)]
    mask = np.ones(conf.batch_size, np.float32)
    mask[-1] = 0.0
    init = trainer.build_model().reset_parameters(
        torch.Generator().manual_seed(SEED)).state_dict()
    init_params = snapshot(init)
    limit = TRAIN_STEP_ATOL["params"]

    def run(dev, dtype, stage):
        model = trainer.build_model()
        model.load_state_dict(init)
        model.to(device=dev, dtype=dtype)
        group = {id(p) for p in stage_groups(model)[stage]}
        inside = [n for n, p in model.named_parameters() if id(p) in group]
        optimizer = make_optimizer(
            stage_groups(model)[stage], conf.optimizer,
            learning_rate=conf.learning_rate,
            weight_decay=conf.weight_decay)
        state = TrainState(model, optimizer, torch.Generator(device=dev))
        mu_d, std_d = (torch.from_numpy(a).to(dev, dtype) for a in (mu, std))
        ident = torch.as_tensor(model.class_identity_windows(), device=dev,
                                dtype=dtype)
        steps, _ = make_ppnet_steps(
            model, None if two_d else (
                lambda d: transform_batch(d, mu_d, std_d)), ident,
            model.max_dist, conf.clust_lambda, conf.sep_lambda,
            dropout_active=False,
            bn_mask_rows="batch" if two_d else "windows")
        x, t, m = (torch.from_numpy(a).to(dev, dtype)
                   for a in (raw, targets, mask))
        out = steps[stage](state, x, t, m).cpu().double().numpy()
        return out, snapshot(model.state_dict()), inside

    fields = {"atol": TRAIN_STEP_ATOL}
    failed = []
    for dtype_name, dtype in (("float32", torch.float32),
                              ("float64", torch.float64)):
        f32 = dtype == torch.float32
        for stage in STAGES:
            cpu_out, cpu_params, inside = run("cpu", dtype, stage)
            dev_out, dev_params, _ = run(device, dtype, stage)
            outside = [n for n in init if n not in inside]
            held = [n for n in inside if not (
                f32 and n.startswith(BY_GRADIENT[name]))]
            atol = limit if f32 else STAGE_F64_ATOL
            loss_err = float(np.abs(dev_out - cpu_out).max())
            over = elements_over(dev_params, cpu_params, held, atol)
            def moved_outside(params):
                return [n for n in outside
                        if not torch.equal(params[n], init[n].double())]

            moved = {"device": moved_outside(dev_params),
                     "cpu": moved_outside(cpu_params)}
            stage_moved = max(float((cpu_params[n] - init[n].double())
                                    .abs().max()) for n in inside)
            fields["{}_{}".format(dtype_name, stage)] = {
                "loss_and_parts_device": dev_out.tolist(),
                "max_abs_loss_parts": loss_err, "params_in_stage":
                len(inside), "over_atol_held": over,
                "params_outside_moved": moved,
                "max_abs_params": max(float((dev_params[n] - cpu_params[n])
                                            .abs().max()) for n in inside),
                "stage_moved_max_abs": stage_moved}
            if loss_err > TRAIN_STEP_ATOL["loss"] or over or any(
                    moved.values()):
                failed.append("{} {}: loss {}, over {}, outside moved {}"
                              .format(dtype_name, stage, loss_err, over,
                                      moved))
            # planted: the stage's most moved param left at its init, an
            # outside param moved by 1e-6
            target_param = max(held, key=lambda n: float(
                (cpu_params[n] - init[n].double()).abs().max()))
            planted = dict(dev_params)
            planted[target_param] = init[target_param].double()
            caught = bool(elements_over(planted, cpu_params, held, atol))
            fields["{}_{}".format(dtype_name, stage)]["planted_caught"] = \
                caught
            nudged = dict(init_params)
            nudged[outside[0]] = nudged[outside[0]] + 1e-6
            if (not caught and (not f32 or stage_moved > limit)) or \
                    moved_outside(nudged) != [outside[0]]:
                raise AssertionError("the {} {} stage check would pass a "
                                     "planted fault".format(dtype_name,
                                                            stage))
    if failed:
        raise AssertionError("{} card vs CPU: {}".format(
            name, "; ".join(failed)))
    return fields


def push_card_vs_cpu(workdir, device, name="config5"):
    """The push over 64 full-width windows of 8 patients (batch 16, the
    last batch padded) on the device and on the CPU from the same params:
    the same winners (window, position) and distances within PUSH_ATOL
    of max(1, distance), the prototype vectors within PUSH_ATOL.  A winner
    may differ only where the two sides' best distances agree so (a tie
    within rounding; counted).  Planted: the vectors of another
    prototype.  protopnet_2d: over the train images of ``two_d_datasets``
    (10 patients), each side gathering them with the same transforms."""
    import torch

    two_d = name in TWO_D_FLAGS
    rng = np.random.default_rng(SEED + 15)
    if two_d:
        trainer = two_d_trainer(name, "cpu")
    else:
        trainer = ppnet_trainer("cpu")
        ds = cohort_dataset(workdir, make_windows(rng, 56), [0, 1] * 4, 7)
    base = trainer.build_model().reset_parameters(
        torch.Generator().manual_seed(SEED + 1)).state_dict()
    sides = {}
    for dev in (device, "cpu"):
        if two_d:
            trainer = two_d_trainer(name, dev)
            ds, _ = two_d_datasets(trainer, workdir, 10, 5, SEED + 15)
        else:
            trainer = ppnet_trainer(dev)
        trainer.push_infos = []
        model = trainer.build_model()
        model.load_state_dict(base)
        model.to(dev)
        info = trainer.push_prototypes(model, ds)
        sides[dev] = (info, model.prototype_vectors.detach().cpu().double())
    (d_info, d_vec), (c_info, c_vec) = sides[device], sides["cpu"]
    if any(i is None for i in d_info + c_info):
        raise AssertionError("a prototype found no window of its class")
    ties, failed = [], []
    for j, (a, b) in enumerate(zip(d_info, c_info)):
        close = abs(a["distance"] - b["distance"]) <= PUSH_ATOL * max(
            1.0, abs(b["distance"]))
        same = (a["window_index"], a["flat_pos"]) == (b["window_index"],
                                                      b["flat_pos"])
        if not close:
            failed.append("prototype {}: {} vs {}".format(j, a, b))
        elif not same:
            ties.append(j)
    same = [j for j in range(len(d_info)) if j not in ties]
    vec_err = float((d_vec[same] - c_vec[same]).abs().max())
    planted = float((d_vec - c_vec.roll(1, dims=0)).abs().max())
    if planted <= PUSH_ATOL:
        raise AssertionError("the push check would pass another "
                             "prototype's vector")
    if vec_err > PUSH_ATOL:
        failed.append("prototype vectors: {}".format(vec_err))
    fields = {"windows": len(ds), "prototypes": len(d_info),
              "atol": PUSH_ATOL,
              "winners_equal": len(same), "ties_within_atol": ties,
              "max_abs_vectors": vec_err,
              "max_rel_distance": max(abs(a["distance"] - b["distance"])
                                      / max(1.0, abs(b["distance"]))
                                      for a, b in zip(d_info, c_info)),
              "planted_other_prototype": planted}
    if failed:
        raise AssertionError("push card vs CPU: " + "; ".join(failed))
    return fields


def ppnet_graph_vs_eager(workdir, device, name="config5"):
    """GRAPH_STEPS steps of each stage in turn (warm, joint, last) from
    one fold state, then an eval epoch, graphed and eager: float32 with
    dropout off, losses and their parts, params and eval logits within
    GRAPH_ATOL; bfloat16 with dropout on, losses within GRAPH_ATOL and
    the generators equal.  Returns (fields, failures, the graphed bf16
    runners)."""
    import torch

    from deepards_tpu_torch.train.loop import _epoch_order
    from deepards_tpu_torch.train.protopnet_trainer import STAGES

    rng = np.random.default_rng(SEED + 16)
    n = GRAPH_STEPS * BATCH
    ds = cohort_dataset(workdir, make_windows(rng, n), [0, 1] * 4, n // 8)
    ids, masks = _epoch_order(rng.permutation(n), BATCH)
    masks[-1, -3:] = 0.0
    fields = {"steps_a_stage": GRAPH_STEPS, "atol": GRAPH_ATOL}
    failed, timed = [], None
    deterministic = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    try:
        for dtype, dropout in (("float32", False), ("bfloat16", True)):
            runs = {}
            for graphs in (False, True):
                trainer = ppnet_trainer(device, "--compute-dtype", dtype,
                                        name=name)
                state = trainer.new_state(0)
                runners = trainer.make_runners(
                    state, ds, dropout=dropout,
                    graphed=graphs and trainer.device.type == "cuda")
                losses = [trainer._device_steps(runners[stage], ds, ids,
                                                masks, True)[0].cpu()
                          for stage in STAGES]
                _, outs = trainer._device_steps(runners["last"], ds, ids,
                                                masks, False)
                runs[graphs] = (torch.stack(losses),
                                snapshot(state.model.state_dict()),
                                outs.cpu(), state.generator.get_state())
                if graphs and dropout:
                    timed = runners
            e_loss, e_params, e_out, e_rng = runs[False]
            g_loss, g_params, g_out, g_rng = runs[True]
            loss_err = float((g_loss - e_loss).abs().max())
            param_err = max(float((g_params[k] - e_params[k]).abs().max())
                            for k in e_params)
            out_err = float((g_out - e_out).abs().max())
            same_rng = bool(torch.equal(g_rng, e_rng))
            fields[dtype] = {"dropout": dropout, "max_abs_loss": loss_err,
                             "max_abs_params": param_err,
                             "max_abs_eval_logits": out_err,
                             "generator_state_equal": same_rng}
            if loss_err > GRAPH_ATOL or (not dropout and (
                    param_err > GRAPH_ATOL or out_err > GRAPH_ATOL)) or (
                    dropout and not same_rng):
                failed.append("{}: {}".format(dtype, fields[dtype]))
    finally:
        torch.backends.cudnn.deterministic = deterministic
    return fields, failed, timed


def push_seconds(workdir, device):
    """The push over a MEASURE_WINDOWS-window cache (full width, batch
    16, 256 batches) on the device: seconds."""
    import torch

    rng = np.random.default_rng(SEED + 17)
    ds = cohort_dataset(workdir, make_windows(rng, MEASURE_WINDOWS),
                        [0, 1] * 32, MEASURE_WINDOWS // 64)
    trainer = ppnet_trainer(device)
    trainer.push_infos = []
    model = trainer.build_model().reset_parameters(
        torch.Generator().manual_seed(SEED)).to(device)
    trainer._get_device_cache(ds)  # uploaded once, as in training
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    trainer.push_prototypes(model, ds)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    return {"windows": MEASURE_WINDOWS, "batches": MEASURE_WINDOWS // BATCH,
            "seconds": seconds,
            "windows_per_s": MEASURE_WINDOWS / seconds}


def cams_card_vs_cpu(model, xs, targets, device):
    """``MaxMinNormCam`` of ``model`` over sequences ``xs`` on the device
    and on the CPU: the raw cams within CAM_ATOL, but those of a window
    where a feature crosses 0 on one side only (the head's ReLU makes the
    cam jump there; counted, at most 1% of the cams), the outputs within
    CAM_ATOL, the uint8 cams (count of elements apart).  Planted: the
    other class's cams.  Returns (fields, the device's cam generator)."""
    from deepards_tpu_torch.explain.gradcam import MaxMinNormCam

    sides = {}
    for dev in (device, "cpu"):
        cam = MaxMinNormCam(copy.deepcopy(model).to(dev))
        raw, outs = cam.read_cams_batch(xs, targets)
        normed, _ = cam.generate_read_cams_batch(xs, targets)
        positive = cam._fmaps_and_grads(xs, targets)[0].cpu().numpy() > 0
        sides[dev] = (raw, outs, normed, cam, positive)
    (d_raw, d_out, d_norm, d_cam, d_pos), (c_raw, c_out, c_norm, _,
                                           c_pos) = sides[device], sides["cpu"]
    # a feature within rounding of 0 may pass the head's ReLU on one side
    # only: its gradient, and so the cam of its window, jumps there
    flipped = (d_pos != c_pos).any(axis=(2, 3))  # (sequences, S)
    other, _ = d_cam.read_cams_batch(xs, 1 - targets)
    err = float(np.abs(d_raw - c_raw)[~flipped].max())
    fields = {"sequences": len(xs), "atol": CAM_ATOL,
              "max_abs_cam": err,
              "cams_with_a_relu_flip": int(flipped.sum()),
              "max_abs_cam_with_a_relu_flip": float(
                  np.abs(d_raw - c_raw)[flipped].max()) if flipped.any()
              else 0.0,
              "cam_scale": float(np.abs(c_raw).max()),
              "max_abs_output": float(np.abs(d_out - c_out).max()),
              "uint8_elements_apart": int((d_norm != c_norm).sum()),
              "uint8_max_apart": int(np.abs(d_norm.astype(int)
                                            - c_norm.astype(int)).max()),
              "planted_other_class": float(np.abs(other - c_raw).max())}
    if fields["planted_other_class"] <= CAM_ATOL:
        raise AssertionError("the cam check would pass the other class's "
                             "cams")
    if err > CAM_ATOL or fields["max_abs_output"] > CAM_ATOL or \
            d_raw.shape != xs.shape[:2] + (7,) or flipped.mean() > 0.01:
        raise AssertionError("gradcam card vs CPU: {}".format(fields))
    return fields, d_cam


def gradcam_card_vs_cpu(device):
    """``cams_card_vs_cpu`` over CAM_SEQUENCES full-width sequences of a
    seeded cnn_linear/densenet18; cams/s of the whole call and of the
    device pass."""
    import torch

    from deepards_tpu_torch.models import densenet1d, heads

    rng = np.random.default_rng(SEED + 18)
    xs = make_windows(rng, CAM_SEQUENCES)
    xs = (xs - xs.mean()) / xs.std()
    targets = np.ones(CAM_SEQUENCES, np.int64)
    model = heads.CNNLinearNetwork(densenet1d.densenet18(), S)
    model.reset_parameters(torch.Generator().manual_seed(SEED + 5))
    fields, d_cam = cams_card_vs_cpu(model, xs, targets, device)
    if device == "cuda":
        fields["call_ms"] = cuda_ms(
            lambda: d_cam.generate_read_cams_batch(xs, targets), warmup=1,
            reps=5)
        fields["device_pass_ms"] = cuda_ms(
            lambda: d_cam._fmaps_and_grads(xs, targets), warmup=1, reps=5)
        fields["cams_per_s"] = CAM_SEQUENCES * 1e3 / fields["call_ms"]
        fields["device_pass_cams_per_s"] = (CAM_SEQUENCES * 1e3
                                            / fields["device_pass_ms"])
        fields["device_pass"] = step_profile(
            lambda: d_cam._fmaps_and_grads(xs, targets), reps=5)
    return fields


def phase_config5(workdir, device="cuda"):
    """Config 5 (ProtoPNet over densenet18) on the device: the CLI with
    CONFIG5_CUT (every stage, two pushes), one step of each stage card vs
    CPU, the push card vs CPU, graphed vs eager for each stage, the timed
    bf16 step of each stage and the push over MEASURE_WINDOWS windows, and
    GradCAM over CAM_SEQUENCES sequences card vs CPU with cams/s."""
    t0 = time.perf_counter()
    trainer, _, run = train_config(workdir, device, "config5", epochs=3,
                                   extra=CONFIG5_CUT)
    pushes = trainer.push_infos
    if len(pushes) != 2 or any(i is None for p in pushes for i in p):
        raise AssertionError("config5 pushes: {}".format(pushes))
    meters = trainer.results.reporting.meters
    aux = {m: len(meters["{}_fold_4".format(m)].values)
           for m in ("cls_loss", "clst_loss", "sep_loss", "l1_loss")}
    run["cut"] = CONFIG5_CUT
    fields = {"card": nvidia_smi_line() if device == "cuda" else None,
              "flags": CONFIG_FLAGS["config5"], "run": run,
              "pushes": len(pushes), "aux_meter_steps_fold_4": aux,
              "last_push_info": pushes[-1][:4],
              "card_vs_cpu": ppnet_card_vs_cpu(device),
              "push_card_vs_cpu": push_card_vs_cpu(workdir, device)}
    fields["graph_vs_eager"], failed, runners = ppnet_graph_vs_eager(
        workdir, device)
    fields["gradcam"] = gradcam_card_vs_cpu(device)
    if device == "cuda":
        fields["numbers"] = {
            "batch": BATCH, "compute_dtype": "bfloat16",
            **{stage: step_profile(runner.train)
               for stage, runner in runners.items()},
            "eval": step_profile(runners["last"].eval),
            "push": push_seconds(workdir, device)}
        print("numbers config5: {} ms a joint step, push {} s, {} cams/s"
              .format(fields["numbers"]["joint"]["ms"],
                      fields["numbers"]["push"]["seconds"],
                      fields["gradcam"]["cams_per_s"]), flush=True)
    fields["phase_seconds"] = time.perf_counter() - t0
    emit("config5", **fields)
    if failed:
        raise AssertionError("config5 graphed vs eager: " + "; ".join(failed))



# -- the sequence networks ----------------------------------------------------

# their device-cache epoch, 16 steps of 16 (cut from 64), and a
# profile of 2 steps (an LSTM-only step is ~8,600 kernels, whose events
# the profiler is slow to take in)
SEQUENCE_MEASURE_WINDOWS = 256
NESTED_ATOL = 1e-5  # real windows' logits, padded vs their own bucket
NESTED_PATIENT = 20  # windows of a synthetic patient (400 breaths of S = 20)
# one real-size step: a 24 h patient is ~1,440 windows of 20 breaths, its
# bucket 2,048 (40,960 breaths through densenet18); ~28 GB of saved
# activations is an estimate from the tensors autograd saves on the CPU
REAL_WINDOWS, REAL_BUCKET, REAL_ESTIMATE_GB = 1440, 2048, 28
REAL_SIZE_NETWORK = "cnn_to_nested_lstm"


def phase_sequence(workdir, device="cuda"):
    """Each sequence network (SEQUENCE_FLAGS, ``sequence_path``)."""
    return counted_phase("sequence", SEQUENCE_FLAGS, sequence_path, workdir,
                         device)


def sequence_path(workdir, name, device="cuda"):
    """Network ``name`` trained through the CLI (fold 0 of 5, one epoch),
    3 float32 and float64 steps at full width held against the CPU, graphed
    steps held to eager ones, a trained checkpoint served and predicted,
    each held to the trainer; a nested network's padding held exact
    (``nested_padding``); on the card the bf16 graphed step timed (a
    nested network's at a synthetic patient's size, and REAL_SIZE_NETWORK
    at a real patient's).  Returns (fields, failures) of ``run_stages``."""
    fold = {}

    def train(fields):
        fold["trainer"], fold["dir"], fields["run"] = train_config(
            workdir, device, name, 1, ["--only-fold", "0"], (0,))
        fields["eval_logits_shape"] = list(
            fold["trainer"].last_eval["logits"].shape)

    def serve(fields):
        fields["train_to_serve"] = train_to_serve(
            fold["trainer"], fold["dir"], device, name, 0)

    def predict(fields):
        cohort_dir, cohort = config_cohort(workdir, fold["trainer"].conf)
        fields["predict"] = predict_vs_eval(CONFIG_FLAGS[name] + [
            "--data-path", cohort_dir, "--cohort-file", cohort,
            "--only-fold", "0", "--device", device],
            os.path.join(fold["dir"], name + "-fold0"),
            os.path.join(workdir, name))

    def padding(fields):
        fields["padding"] = nested_padding(workdir, device, name)
        if fields["padding"]["max_abs"] > NESTED_ATOL:
            return ["padded logits {}".format(fields["padding"]["max_abs"])]

    def numbers(fields):
        if name in NESTED_NETWORKS:
            fields["numbers"] = nested_numbers(workdir, device, name)
        else:
            # the profiler's cost goes with the kernels: ~8,600 an
            # LSTM-only step, timed over 5 steps and one run of 20
            fields["numbers"] = train_numbers(
                workdir, device, name, (("graphed", True),),
                SEQUENCE_MEASURE_WINDOWS,
                **(dict(NEW_DEPTH["reps"], profile_reps=1)
                   if name in LSTM_ONLY else NEW_DEPTH["reps"]))

    stages = [("train", train),
              # 2 steps from the fold's state (cut from 8 for time)
              ("graph_vs_eager", check_graph_vs_eager(workdir, name, device)),
              ("serve", serve), ("predict", predict)]
    if name in NESTED_NETWORKS:
        stages.append(("padding", padding))
    if device == "cuda":
        stages.append(("numbers", numbers))
        if name == REAL_SIZE_NETWORK:
            stages.append(("real_size", lambda fields: fields.update(
                real_size_step=nested_real_size(workdir, device, name))))
    # last: the worker computes the CPU's side meanwhile
    stages.append(("card_vs_cpu", check_card_vs_cpu(name, device)))
    return run_stages(name, stages, device)


def nested_padding(workdir, device, name):
    """A nested network's padding, float32 with dropout off, on the
    device: a patient of NESTED_PATIENT real windows padded to 32 and to
    64 (the RNN and LSTM: to 32 against its own 20, unpadded) must give
    its real windows the same logits within NESTED_ATOL.  Planted: the
    RNN and LSTM run the padded patient with its windows in reverse (pad
    windows first) and the transformer without its window mask; each
    must move those logits by more."""
    import torch

    from deepards_tpu_torch.train.nested_trainer import make_nested_steps

    trainer, state = nested_fold(name, workdir, device, "float32")
    _, eval_step = make_nested_steps(trainer.loss_fn, dropout_active=False)
    gen = torch.Generator(device=trainer.device).manual_seed(SEED + 7)
    w, s = NESTED_PATIENT, trainer.n_sub_batches
    windows = torch.randn((w, s, C, L), generator=gen,
                          device=trainer.device)
    target = torch.tensor([[0.0, 1.0]], device=trainer.device)
    transformer = name == "cnn_to_nested_transformer"

    def logits(size, reverse=False, masked=True):
        data = torch.zeros((1, size, s, C, L), device=trainer.device)
        data[0, :w] = windows
        mask = torch.zeros((1, size), device=trainer.device)
        mask[0, :w] = 1.0
        if reverse:
            data, mask = data.flip(1), mask.flip(1)
        if not masked:
            mask = torch.ones_like(mask)
        _, out = eval_step(state, data, target, mask)
        out = out[0].flip(0) if reverse else out[0]
        return out[:w].double().cpu()

    own = logits(32 if transformer else w)
    padded = logits(64 if transformer else 32)
    planted = (logits(64, masked=False) if transformer
               else logits(32, reverse=True))
    fields = {"windows": w, "buckets": [32, 64] if transformer else [w, 32],
              "max_abs": float((padded - own).abs().max()),
              "atol": NESTED_ATOL,
              "planted": "no window mask" if transformer
              else "windows reversed, pad windows first",
              "planted_max_abs": float((planted - own).abs().max())}
    if fields["planted_max_abs"] <= NESTED_ATOL:
        raise AssertionError("{}: the padding check would pass {}".format(
            name, fields["planted"]))
    return fields


def nested_numbers(workdir, device, name):
    """The bf16 graphed train and eval steps (dropout on) of a patient of
    NESTED_PATIENT windows (bucket 32), with the runner's build time and
    the peak memory of the build and the steps."""
    import torch

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    baseline = torch.cuda.memory_allocated()
    t0 = time.perf_counter()
    trainer, state = nested_fold(name, workdir, device, "bfloat16")
    runners = nested_runners(trainer, state, True)
    conf = trainer.conf
    ds = random_cache(np.random.default_rng(SEED + 3), NESTED_PATIENT, conf)
    groups = [("synthetic", np.arange(NESTED_PATIENT), 1)]
    trainer.patient_steps(runners, ds, groups, True)  # builds the runner
    torch.cuda.synchronize()
    build_seconds = time.perf_counter() - t0
    runner = runners[32]
    out = {"windows": NESTED_PATIENT, "bucket": 32,
           "breaths": 32 * conf.n_sub_batches, "compute_dtype": "bfloat16",
           "step": step_profile(runner.train),
           "eval": step_profile(runner.eval),
           "runner_build_seconds": build_seconds,
           "peak_memory_bytes": torch.cuda.max_memory_allocated() - baseline}
    print("numbers {}: {} ms a step, {} ms on the device, {} kernels".format(
        name, out["step"]["ms"], out["step"]["device_ms"],
        out["step"]["launches"]), flush=True)
    return out


def nested_real_size(workdir, device, name):
    """One bf16 graphed train step of a REAL_WINDOWS-window patient in its
    bucket, REAL_BUCKET, from seeded windows made on the card: its time,
    device time and kernels, and the peak memory of the runner's build
    (eager warm-up steps and the captures) beside REAL_ESTIMATE_GB.  A
    bucket that does not fit in the card's memory gives way to the next
    smaller one, filled to the same share of real windows; the largest
    that fits is the reading."""
    import gc

    import torch

    tried = []
    size = REAL_BUCKET
    while size >= 64:
        w = REAL_WINDOWS * size // REAL_BUCKET
        gc.collect()
        torch.cuda.empty_cache()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        baseline = torch.cuda.memory_allocated()
        try:
            t0 = time.perf_counter()
            trainer, state = nested_fold(name, workdir, device, "bfloat16")
            runners = nested_runners(trainer, state, True)
            runner = runners[size]
            torch.cuda.synchronize()
            build_seconds = time.perf_counter() - t0
            peak = torch.cuda.max_memory_allocated() - baseline
            gen = torch.Generator(device=trainer.device).manual_seed(SEED)
            inputs = runner.inputs
            inputs["data"][0, :w] = torch.randn(
                (w,) + tuple(inputs["data"].shape[2:]), generator=gen,
                device=trainer.device)
            inputs["mask"][0, :w] = 1.0
            inputs["mask"][0, w:] = 0.0
            inputs["target"].copy_(torch.tensor([[0.0, 1.0]]))
            ms = cuda_ms(runner.train, warmup=1, reps=3)
            prof = device_breakdown(runner.train, reps=1, top=4)
            loss = float(runner.train())
            if name == "cnn_to_nested_lstm" and \
                    prof["lstm_launches_per_call"] != 2:
                raise AssertionError(
                    "real-size step: {} LSTM kernel launches, not the "
                    "forward and the backward".format(
                        prof["lstm_launches_per_call"]))
            reading = {
                "windows": w, "bucket": size,
                "breaths": size * trainer.n_sub_batches,
                "compute_dtype": "bfloat16", "ms": ms,
                "device_ms": prof["device_ms_per_call"],
                "launches": prof["kernel_launches_per_call"],
                "lstm_launches": prof["lstm_launches_per_call"],
                "device_idle_share": 1.0 - prof["device_ms_per_call"] / ms,
                "top": prof["top"],
                "runner_build_seconds": build_seconds,
                "peak_memory_bytes": peak,
                "memory_reserved_bytes": torch.cuda.memory_reserved(),
                "estimate_gb": REAL_ESTIMATE_GB, "loss": loss,
                "did_not_fit": tried}
            if not np.isfinite(loss):
                raise AssertionError("real-size step: loss {}".format(loss))
            print("real-size {} step: {} windows in bucket {}: {} ms, peak "
                  "{} GB (estimate {} GB)".format(
                      name, w, size, ms, peak / 1e9, REAL_ESTIMATE_GB),
                  flush=True)
            return reading
        except torch.cuda.OutOfMemoryError as exc:
            tried.append({"bucket": size, "error": str(exc)[:200]})
            print("real-size step: bucket {} does not fit".format(size),
                  flush=True)
        finally:
            trainer = state = runners = runner = inputs = None
            gc.collect()
            torch.cuda.empty_cache()
        size //= 2
    raise AssertionError("no real-size bucket fits: {}".format(tried))


# the DTW heterogeneity sweep: the reference hetero runner's cohort of 80
# patients (its ``hetero`` defaults: train_n 40, test_n 6), 60 windows each
SIM_PATIENTS, SIM_WINDOWS, SIM_N_RANDOM = 80, 60, 50
SIM_KEEP = 256  # pairs of the sweep's first chunk held to dtw_reference
# the sub-cohort held card vs CPU (cut from 8 patients for time)
SUB_PATIENTS, SUB_N_RANDOM = 6, 4


def cohort_dataset(workdir, data, patho, n_windows, total_kfolds=None):
    """An ``ARDSRawDataset`` over windows ``data`` of len(patho) patients
    ("1", "2", ...) with ``n_windows`` each (or one count a patient),
    patient k of class patho[k], in ``total_kfolds`` folds if given."""
    from deepards_tpu_torch.data.dataset import ARDSRawDataset
    from deepards_tpu_torch.data.windowing import WindowCache

    n_patients = len(patho)
    counts = np.broadcast_to(n_windows, (n_patients,))
    cohort = os.path.join(workdir, "cohort-{}.csv".format(n_patients))
    with open(cohort, "w") as f:
        f.write("Patient Unique Identifier,Pathophysiology\n")
        f.writelines("{},{}\n".format(k + 1, "ARDS" if y else "OTHER")
                     for k, y in enumerate(patho))
    cache = WindowCache(
        data=data,
        target=np.eye(2, dtype=np.float32)[np.repeat(patho, counts)],
        hours=np.concatenate([
            np.arange(c * data.shape[1], dtype=np.float32).reshape(c, -1)
            * 0.05 for c in counts]),
        patient_idx=np.repeat(np.arange(n_patients), counts).astype(
            np.int32),
        patients=[str(k + 1) for k in range(n_patients)])
    return ARDSRawDataset(workdir, 1, cohort, data.shape[1],
                          "unpadded_centered_sequences", cache=cache,
                          total_kfolds=total_kfolds)


def similarity_cohort(n_patients=SIM_PATIENTS, n_windows=SIM_WINDOWS,
                      nb=S):
    """``dtw_similarity``'s seeded windows and classes: ``n_patients`` x
    ``n_windows`` windows of (nb, 1, 224), half of the patients ARDS, each
    patient's flow at its own scale."""
    rng = np.random.default_rng(SEED + 7)
    patho = np.arange(n_patients) % 2
    data = make_windows(rng, n_patients * n_windows, nb)
    data *= np.repeat(rng.uniform(0.6, 1.4, n_patients),
                      n_windows)[:, None, None, None].astype(np.float32)
    return data, patho


def sub_cohort_similarity(workdir, device, data=None, patho=None,
                          n_windows=SIM_WINDOWS):
    """The ``random`` inter-patient matrix of the first SUB_PATIENTS
    patients of ``similarity_cohort`` (or of ``data``) on ``device``:
    {values, patients}."""
    import torch

    from deepards_tpu_torch.dtw.lib import find_patient_similarity

    if data is None:
        data, patho = similarity_cohort(n_windows=n_windows)
    sub = cohort_dataset(workdir, data[:SUB_PATIENTS * n_windows],
                         patho[:SUB_PATIENTS], n_windows)
    mat = find_patient_similarity(sub, dist_method="random",
                                  n_random=SUB_N_RANDOM,
                                  rng=np.random.default_rng(1), device=device)
    return {"values": torch.from_numpy(mat.values),
            "patients": list(mat.patients)}


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

    data, patho = similarity_cohort(n_patients, n_windows, nb)
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

    t1 = time.perf_counter()
    got = sub_cohort_similarity(workdir, device, data, patho, n_windows)
    # the CPU's matrix: the worker's, which computed it meanwhile, in a
    # whole run; else here
    if CPU_SIDES is not None and (None, "similarity") in CPU_SIDES.jobs:
        want = CPU_SIDES.result(None, "similarity")
    else:
        want = sub_cohort_similarity(workdir, "cpu", data, patho, n_windows)
    sub_seconds = time.perf_counter() - t1
    sub_err = float((got["values"] - want["values"]).abs().max())
    if sub_err != 0.0 or got["patients"] != want["patients"]:
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


# the explain phase: one patient of dtw_similarity's per-patient size (60
# windows, 1,200 breaths) for dtw_clust; the others smaller
EXPLAIN_WINDOWS, EXPLAIN_OTHER_WINDOWS, EXPLAIN_PATIENTS = 60, 8, 10
EXPLAIN_KFOLDS = 5
EXPLAIN_OPS = ("medians", "averages", "sample_seqs", "read_cam",
               "cam_by_hour", "rand_sample")
SIMILAR_WINDOWS = 1  # find_similar_cam_regions' windows (the JAX default 6)
# PPNet's minimum distances, card vs CPU: 1e-5 of max(1, d, |p|^2), f32
# sums of 128 squares near 40 (as the push's); the features (similarities)
# within what that moves them by and 1e-5 of max(1, |x|); probabilities
# within 1e-5
PROTO_ATOL = 1e-5


def explain_cohort(workdir, nb, n_windows, other_windows, n_patients,
                   kfolds):
    """The explain phase's seeded cohort saved as an ``.npz``: patient "1"
    (class 0) of ``n_windows`` windows, the others of ``other_windows``,
    classes alternating.  Returns (path, the fold whose test split holds
    patient "1")."""
    from deepards_tpu_torch.data.dataset import ARDSRawDataset

    counts = [n_windows] + [other_windows] * (n_patients - 1)
    rng = np.random.default_rng(SEED + 9)
    path = cohort_dataset(workdir, make_windows(rng, sum(counts), nb),
                          np.arange(n_patients) % 2, counts,
                          total_kfolds=kfolds).save(
                              os.path.join(workdir, "explain.npz"))
    ds = ARDSRawDataset.from_pickle(path)
    ds.set_kfold_patient_splits()
    fold = next(k for k in range(kfolds)
                if "1" in ds.kfold_patient_splits[k]["test"])
    return path, fold


def seeded_checkpoint(path, model, seed):
    """``model`` reset from a seeded generator and saved through
    ``train/checkpoint.py``."""
    import torch

    from deepards_tpu_torch.train import checkpoint as ckpt

    model.reset_parameters(torch.Generator().manual_seed(seed))
    return ckpt.save(path, model.state_dict())


def dtw_matrix_vs_reference(spans, D, device):
    """The op's matrix against ``dtw_reference`` on the device over the same
    spans, exactly; planted: one span's length off by one."""
    import torch

    from deepards_tpu_torch.ops.dtw import dtw_reference

    lens = np.array([len(s) for s in spans], np.int32)
    padded = np.zeros((len(spans), lens.max()), np.float32)
    for i, s in enumerate(spans):
        padded[i, :lens[i]] = s
    spans_d = torch.from_numpy(padded).to(device)

    def reference(lengths, ii, jj, chunk=65536):
        lens_d = torch.from_numpy(lengths).to(device)
        out = []
        for lo in range(0, len(ii), chunk):
            a, b = (torch.from_numpy(x[lo:lo + chunk]).to(device)
                    for x in (ii, jj))
            out.append(dtw_reference(spans_d[a], spans_d[b], lens_d[a],
                                     lens_d[b]).cpu().numpy())
        return np.concatenate(out).astype(np.float64)

    ii, jj = np.triu_indices(len(spans), k=1)
    want = reference(lens, ii, jj)
    err = float(np.abs(D[ii, jj] - want).max())
    planted = lens.copy()
    planted[0] -= 1
    touched = (ii == 0) | (jj == 0)
    planted_err = float(np.abs(
        D[ii[touched], jj[touched]]
        - reference(planted, ii[touched], jj[touched])).max())
    if err != 0.0 or (D != D.T).any() or np.diag(D).any():
        raise AssertionError("dtw_clust matrix vs dtw_reference: max abs "
                             "{}".format(err))
    if planted_err == 0.0:
        raise AssertionError("the matrix check would pass a span length "
                             "off by one")
    return {"max_abs_err": err, "planted_length_off_by_one": planted_err,
            "pairs": len(ii)}


def dtw_clust_kernel_ms(spans, device, chunk=4096):
    """The DTW kernel's own device time (torch.profiler) over ``dtw_clust``'s
    chunks of its spans, gathered on the device as the op gathers them:
    (ms in all, ms a launch, launches)."""
    import torch

    from deepards_tpu_torch.ops.dtw import dtw_cuda
    from deepards_tpu_torch.ops.dtw_timing import device_ms

    lens = np.array([len(s) for s in spans], np.int32)
    padded = np.zeros((len(spans), lens.max()), np.float32)
    for i, s in enumerate(spans):
        padded[i, :lens[i]] = s
    ii, jj = np.triu_indices(len(spans), k=1)
    spans_d, lens_d, ii_d, jj_d = (torch.from_numpy(x).to(device)
                                   for x in (padded, lens, ii, jj))

    def loop():
        for lo in range(0, len(ii), chunk):
            a, b = ii_d[lo:lo + chunk], jj_d[lo:lo + chunk]
            dtw_cuda(spans_d[a], spans_d[b], lens_d[a], lens_d[b])

    launches = -(-len(ii) // chunk)
    per_launch = device_ms(loop, reps=1)
    return per_launch * launches, per_launch, launches


def phase_explain(workdir, device="cuda", cam_checkpoint=None,
                  ppnet_checkpoint=None, per_cell=None, nb=S,
                  n_windows=EXPLAIN_WINDOWS,
                  other_windows=EXPLAIN_OTHER_WINDOWS,
                  n_patients=EXPLAIN_PATIENTS, kfolds=EXPLAIN_KFOLDS):
    """The explain CLIs at full width on a seeded cohort: ``dtw_clust``
    through ``cli.patient_gradcam --only-patient 1`` (the cams, the
    cam-active spans, their DTW matrix through the kernel, KMedoids) timed
    by stage and by the profiler, its cams and outputs equal to those of
    the same checkpoint's model held against the CPU, its matrix against
    ``dtw_reference`` exactly and its distortions against KMedoids on that
    matrix; the other six ops through the CLI; ``find_similar_cam_regions``
    with the cams on the device held against the CPU's;
    ``cli.protopnet_analysis`` on a ProtoPNet checkpoint, its distances
    and probabilities held against the CPU in the same batches and its
    features against the similarity of its own distances.
    ``cam_checkpoint`` (cnn_linear/densenet18) and ``ppnet_checkpoint``
    (config 5's PPNet) default to seeded ones.  Returns the kernel
    launches of ``dtw_clust``."""
    import torch

    import deepards_tpu_torch.ops.dtw as dtw_ops
    from deepards_tpu_torch.cli import patient_gradcam as gradcam_cli
    from deepards_tpu_torch.cli import protopnet_analysis as ppnet_cli
    from deepards_tpu_torch.data.dataset import ARDSRawDataset
    from deepards_tpu_torch.data.pipeline import gather_pipeline
    from deepards_tpu_torch.dtw.kmedoids import KMedoids
    from deepards_tpu_torch.explain.dtw_gradcam import (
        find_similar_cam_regions,
    )
    from deepards_tpu_torch.explain.patient_gradcam import (
        PATHO_NAME,
        StageTimer,
    )
    from deepards_tpu_torch.explain.prototypes import ProtoPNetAnalysis
    from deepards_tpu_torch.models import densenet1d, heads, protopnet1d
    from deepards_tpu_torch.train import checkpoint as ckpt

    def path(*parts):
        return os.path.join(workdir, *parts)

    t_phase = time.perf_counter()
    os.makedirs(path("explain"), exist_ok=True)
    data_path, fold = explain_cohort(path("explain"), nb, n_windows,
                                     other_windows, n_patients, kfolds)
    cam_model = heads.CNNLinearNetwork(densenet1d.densenet18(), nb)
    if cam_checkpoint is None:
        cam_checkpoint = seeded_checkpoint(path("explain", "cnn_linear.pt"),
                                           cam_model, SEED + 10)
    cam_model.load_state_dict(ckpt.restore(cam_checkpoint)["params"])
    ppnet = protopnet1d.construct_ppnet(densenet1d.densenet18(),
                                        sub_batch_size=nb, n_prototypes=10)
    if ppnet_checkpoint is None:
        ppnet_checkpoint = seeded_checkpoint(path("explain", "ppnet.pt"),
                                             ppnet, SEED + 11)
    ppnet.load_state_dict(ckpt.restore(ppnet_checkpoint)["params"])
    cli_args = [cam_checkpoint, "-pdp", data_path, "--fold", str(fold),
                "--device", device]
    fields = {"card": nvidia_smi_line() if device == "cuda" else None,
              "cohort": {"patients": n_patients, "kfolds": kfolds,
                         "windows_of_patient_1": n_windows,
                         "windows_of_the_others": other_windows,
                         "window": [nb, C, L], "fold": fold},
              "reduced": {"find_similar_cam_regions_windows": "6 -> {}"
                          .format(SIMILAR_WINDOWS)}}

    # dtw_clust on patient "1": the path of the kernel
    timer = StageTimer()
    dtw_ops.launches = 0
    t0 = time.perf_counter()
    results = gradcam_cli.main(cli_args + [
        "--ops", "dtw_clust", "--only-patient", "1", "--results-base-dir",
        path("explain", "dtw_clust")], timer=timer)
    op_seconds = time.perf_counter() - t0
    launches = dtw_ops.launches
    (key, res), = results.items()
    spans, D = res["spans"], res["distance_matrix"]
    lens = np.array([len(s) for s in spans])
    n_spans = len(spans)
    pairs = n_spans * (n_spans - 1) // 2
    with np.load(path("explain", "dtw_clust", "dtw_clustering",
                      PATHO_NAME[key[1]], "1", "elbow.npz")) as z:
        elbow = {k: z[k] for k in z.files}
    distortions = [float(np.min(D[:, KMedoids(k, metric="precomputed")
                                  .fit(D).medoid_indices_], axis=1).sum()
                         / n_spans) for k in elbow["clusters"]]
    if distortions != elbow["distortions"].tolist() or \
            int(elbow["n_sequences"]) != n_spans:
        raise AssertionError("elbow.npz against KMedoids on the op's "
                             "matrix: {} vs {}".format(
                                 elbow["distortions"], distortions))
    test = ARDSRawDataset.make_test_dataset_if_kfold(
        ARDSRawDataset.from_pickle(data_path))
    test.set_kfold_indexes_for_fold(fold)
    gt = test.get_ground_truth()
    xs = gather_pipeline(test)(test.gather(gt.index[gt.patient == "1"])[
        "data"])
    targets = np.full(len(xs), key[1])
    cams, d_cam = cams_card_vs_cpu(cam_model, xs, targets, device)
    # the op's cams (its CLI's model, load and transforms) against those of
    # the model checked above, on one device over the same batch: equal
    normed, outs = d_cam.generate_read_cams_batch(xs, targets)
    other, _ = d_cam.generate_read_cams_batch(xs, 1 - targets)
    cams["op_vs_checked"] = {
        "uint8_elements_apart": int((res["cams"] != normed).sum()),
        "max_abs_output": float(np.abs(res["outputs"] - outs).max()),
        "planted_other_class_elements_apart": int(
            (res["cams"] != other).sum())}
    if res["cams"].shape != normed.shape or \
            cams["op_vs_checked"]["uint8_elements_apart"] or \
            cams["op_vs_checked"]["max_abs_output"]:
        raise AssertionError("dtw_clust's cams vs the checked model's: {}"
                             .format(cams["op_vs_checked"]))
    if not cams["op_vs_checked"]["planted_other_class_elements_apart"]:
        raise AssertionError("the op's cam check would pass the other "
                             "class's cams")
    dtw = {"spans": n_spans, "span_lengths": [int(lens.min()),
                                              int(lens.max())],
           "pairs": pairs, "chunks": -(-pairs // 4096), "launches": launches,
           "stage_seconds": timer.seconds, "op_seconds": op_seconds,
           "cams_card_vs_cpu": cams,
           "matrix_vs_reference": dtw_matrix_vs_reference(spans, D, device),
           "distortions": distortions}
    if device == "cuda":
        device_ms = timer.device_ms
        ii, jj = np.triu_indices(n_spans, k=1)
        width = int(lens.max())
        bound = dtw_bound(
            torch.from_numpy(lens[ii]), torch.from_numpy(lens[jj]),
            per_cell["warp{}".format(-(-width // 32))
                     if width <= 256 else "strip"],
            torch.cuda.get_device_properties(0).multi_processor_count,
            sm_clock_hz())
        # the events around each call hold its host time where the kernel
        # is shorter: the share is of the kernel's own time
        kernel_ms, kernel_ms_per_launch, _ = dtw_clust_kernel_ms(spans,
                                                                 device)
        pass_ms = cuda_ms(lambda: d_cam._fmaps_and_grads(xs, targets),
                          warmup=1, reps=5)
        dtw.update(
            breaths=xs.shape[0] * xs.shape[1],
            cams_device_pass_ms=pass_ms,
            cams_per_s=xs.shape[0] * xs.shape[1] / timer.seconds["cams"],
            device_pass_cams_per_s=xs.shape[0] * xs.shape[1] / pass_ms * 1e3,
            gather_ms=sum(device_ms["gather"]),
            kernel_call_ms=sum(device_ms["kernel"]),
            kernel_call_ms_per_chunk=device_ms["kernel"],
            kernel_ms=kernel_ms, kernel_ms_per_launch=kernel_ms_per_launch,
            width=width, share_of_bound=bound["bound_ms"] / kernel_ms,
            **bound)
        if launches == 0:
            raise AssertionError("dtw_clust launched no kernel")
    fields["dtw_clust"] = dtw
    print("explain dtw_clust: {} spans, {} pairs, {} launches, {} s".format(
        n_spans, pairs, launches, op_seconds), flush=True)

    # the other ops of the CLI, each once
    fields["ops"] = {}
    for op in EXPLAIN_OPS:
        # a pane draws windows of both classes: the fold's test patients
        scope = [] if op == "rand_sample" else ["--only-patient", "1"]
        extra = ["--seqs-per-hour", "4"] if op == "cam_by_hour" else []
        out_dir = path("explain", op)
        t0 = time.perf_counter()
        gradcam_cli.main(cli_args + ["--ops", op, "--results-base-dir",
                                     out_dir] + scope + extra)
        written = sum(len(f) for _, _, f in os.walk(out_dir))
        fields["ops"][op] = {"seconds": time.perf_counter() - t0,
                             "files": written}
        if not written:
            raise AssertionError("{} wrote no file".format(op))

    # find_similar_cam_regions: the cams on the device against the CPU's
    similar = {}
    for dev in (device, "cpu"):
        model = copy.deepcopy(cam_model).to(dev)
        seen = []
        cam = type(d_cam)(model)
        generate = cam.generate_read_cams_batch
        cam.generate_read_cams_batch = lambda x, t: seen.append(
            generate(x, t)) or seen[-1]
        t0 = time.perf_counter()
        found, cam_dists = find_similar_cam_regions(
            cam, test, "1", key[1], n_windows=SIMILAR_WINDOWS,
            rng=np.random.default_rng(SEED))
        similar[dev] = (found, cam_dists, seen[0][0],
                        time.perf_counter() - t0)
    apart = int((similar[device][2] != similar["cpu"][2]).sum())
    same = apart == 0 and len(similar[device][0]) == len(similar["cpu"][0]) \
        and np.array_equal(similar[device][1], similar["cpu"][1])
    fields["find_similar_cam_regions"] = {
        "windows": SIMILAR_WINDOWS, "runs": len(similar[device][1]),
        "runs_kept": len(similar[device][0]),
        "uint8_cam_elements_apart": apart, "same_runs_as_cpu": same,
        "seconds": similar[device][3]}
    if apart == 0 and not same:
        raise AssertionError("find_similar_cam_regions: equal cams, other "
                             "runs")

    # cli.protopnet_analysis on the ProtoPNet checkpoint
    t0 = time.perf_counter()
    analysis, pane = ppnet_cli.main([
        ppnet_checkpoint, "--kfold-from-pickle", data_path, "--kfold-idx",
        str(fold), "-o", path("explain", "protopnet"), "--device", device])
    ppnet_seconds = time.perf_counter() - t0
    cpu_model = copy.deepcopy(ppnet).to("cpu")
    cpu = ProtoPNetAnalysis(cpu_model, analysis.train_ds, analysis.test_ds)
    err, planted = {}, {"distances": 0.0, "features": 0.0}

    def similarity(d):
        """The head's inputs from distances, as the analysis forms them."""
        sims = ppnet.distance_to_similarity(
            torch.from_numpy(np.ascontiguousarray(d))).numpy()
        if ppnet.average_linear:
            sims = sims.reshape(len(d), -1, ppnet.num_prototypes).mean(1)
        return sims

    # a distance |x|^2 + |p|^2 - 2<x, p> rounds at the scale of its terms,
    # ~|p|^2 (near 40) also where the push left it near 0
    squares = np.tile((ppnet.prototype_vectors.detach() ** 2).sum(
        dim=(1, 2)).numpy(), nb)  # (S*P,), the distances' layout
    for split in ("train", "test"):
        d_card, d_cpu = (getattr(a, split + "_distances")
                         for a in (analysis, cpu))
        dist_limit = PROTO_ATOL * np.maximum(np.maximum(1.0, d_cpu),
                                             squares)
        # the card's features against the similarity of its own distances
        # (near d = 0 a distance's rounding moves it by up to 1/eps times)
        feats = getattr(analysis, split + "_features")
        own, reversed_own = similarity(d_card), similarity(d_card[::-1])
        feat_limit = PROTO_ATOL * np.maximum(1.0, np.abs(own))
        err[split] = {
            "distances": float((np.abs(d_card - d_cpu) / dist_limit).max()),
            "features_vs_own_distances": float(
                (np.abs(feats - own) / feat_limit).max()),
            "features_vs_cpu_of_max_1_x": float(
                (np.abs(feats - getattr(cpu, split + "_features"))
                 / np.maximum(1.0, np.abs(own))).max()),
            "least_distance": float(d_cpu.min()),
            "preds": float(np.abs(getattr(analysis, split + "_preds")
                                  - getattr(cpu, split + "_preds")).max()
                           / PROTO_ATOL)}
        planted["distances"] = max(planted["distances"], float(
            (np.abs(d_card[::-1] - d_cpu) / dist_limit).max()))
        planted["features"] = max(planted["features"], float(
            (np.abs(feats - reversed_own) / feat_limit).max()))
    with open(pane + ".txt") as f:
        record = f.read().splitlines()
    fields["protopnet_analysis"] = {
        "checkpoint": os.path.basename(ppnet_checkpoint),
        "windows": [len(analysis.train_gt.index),
                    len(analysis.test_gt.index)],
        "features": list(analysis.test_features.shape[1:]),
        "prototype_squared_norms": [float(squares.min()),
                                    float(squares.max())],
        "over_limit": err, "atol_of_max_1_x": PROTO_ATOL,
        "planted_rows_reversed_over_limit": planted,
        "pane_records": len(record) - 1, "seconds": ppnet_seconds}
    if max(v for e in err.values() for k, v in e.items()
           if k in ("distances", "features_vs_own_distances", "preds")) > 1 \
            or min(planted.values()) <= 1 or len(record) != 17:
        raise AssertionError("protopnet_analysis card vs CPU: {}".format(
            fields["protopnet_analysis"]))
    fields["phase_seconds"] = time.perf_counter() - t_phase
    emit("explain", **fields)
    return launches


# -- the 2D breath-image networks ---------------------------------------------

IMAGE = 224  # an image's H and W: 224 rows of 224 samples
# the timed host epoch: fold 0's train split of 10 patients x 20 images
# (8 patients, 160 images; 16 patients, 240 images before the cut)
MEASURE_PATIENTS, MEASURE_IMAGES_EACH = 10, 20


def two_d_trainer(name, device, *flags):
    """The trainer of 2D network ``name``'s flags, its backbone named and
    its input channels set by ``image_options`` as for its images, ready
    to build models without a cohort."""
    from deepards_tpu_torch.train.loop import make_trainer

    conf = config_conf(name, "--device", device, *flags)
    trainer = make_trainer(conf, verbose=False)
    trainer.n_sub_batches = conf.n_sub_batches
    trainer.image_options()
    return trainer


def two_d_datasets(trainer, workdir, n_patients, images_each, seed):
    """(train, test) ``ImgARDSDataset``s of ``trainer``'s options (FFT
    channels, transforms, patho mix, bbox splices) over flow-like windows
    of ``n_patients`` patients (classes alternating), ``images_each``
    images a patient (a multiple of 5: 56 windows of 20 breaths), fold 0
    of 5, as ``trainer.get_base_datasets`` makes them from a cohort."""
    from deepards_tpu_torch.data.dataset import ARDSRawDataset

    rng = np.random.default_rng(seed)
    n_windows = images_each * IMAGE // S
    raw = cohort_dataset(workdir, make_windows(rng, n_patients * n_windows),
                         [0, 1] * (n_patients // 2), n_windows,
                         total_kfolds=5)
    raw.kfold_num = 0
    raw.set_kfold_indexes_for_fold(0)
    return trainer.image_datasets(
        raw, ARDSRawDataset.make_test_dataset_if_kfold(raw))


def two_d_batch(trainer, batch):
    """A gathered image batch as the trainer's runner reads it: padded
    to the batch size, a detector's band boxes as row labels."""
    from deepards_tpu_torch.models.detection2d import row_labels_from_boxes

    if trainer.spec.kind == "detector":
        batch = {"data": batch["data"], "target": row_labels_from_boxes(
            batch["boxes"], batch["labels"], IMAGE)}
    return trainer.device_batch(batch, trainer.conf.batch_size)


def two_d_runners(trainer, state, ds, dropout=True, graphed=None):
    """{stage or "train": StepRunner} of the trainer's steps over ``ds``'s
    images (one a ProtoPNet stage, the eval with the last); CUDA-graph
    replays on the card unless ``graphed`` says otherwise."""
    from deepards_tpu_torch.train.detector_trainer import make_detector_steps
    from deepards_tpu_torch.train.steps import make_train_step

    conf = trainer.conf
    if graphed is None:
        graphed = trainer.device.type == "cuda"
    if trainer.spec.trainer == "protopnet":
        return trainer.make_runners(state, ds, dropout=dropout,
                                    graphed=graphed)
    if trainer.spec.kind == "detector":
        steps = make_detector_steps(conf.fl_gamma, conf.fl_alpha,
                                    trainer.compute_dtype)
    else:
        options = trainer.step_options(ds)
        options["eval_dropout_active"] &= dropout
        steps = make_train_step(trainer.loss_fn, dropout_active=dropout,
                                **options)
    return {"train": trainer.make_runner(state, ds, *steps,
                                         graphed=graphed)}


def two_d_card_vs_cpu(device, name):
    """Three steps of 2D network ``name`` at full width and its batch
    (normalized 224x224 images; one pad row in a batch of more than 2),
    dropout off, on the device and on the CPU from the same params and
    batches, in float32 and float64: losses within 1e-4 and every param
    element within 1e-5 after each step, but in float32 the first conv,
    held by its float32 gradient on the card against the CPU's float64
    one within 2e-2 of the largest element (the controls, a zero and the
    next batch's gradient, must exceed it), as ``TRAIN_STEP_ATOL`` says.
    The float32 check must pass the CPU against itself with the batch's
    rows permuted, and each check must fail a planted fault: the most
    moved held tensor left at its init."""
    import torch

    from deepards_tpu_torch.models.detection2d import row_labels_from_boxes
    from deepards_tpu_torch.train.detector_trainer import make_detector_steps
    from deepards_tpu_torch.train.steps import (
        TrainState,
        make_optimizer,
        make_train_step,
    )

    trainer = two_d_trainer(name, "cpu")
    conf, batch = trainer.conf, trainer.conf.batch_size
    detector = trainer.spec.kind == "detector"
    rng = np.random.default_rng(SEED + 30)
    images = rng.normal(size=(3, batch, trainer.in_channels, IMAGE,
                              IMAGE)).astype(np.float32)
    if detector:
        starts = rng.integers(20, 120, size=3 * batch)
        boxes = np.array([[[0, 0, IMAGE, a], [0, a, IMAGE, a + 60],
                           [0, a + 60, IMAGE, IMAGE]] for a in starts])
        own = rng.integers(0, 2, size=3 * batch)
        targets = row_labels_from_boxes(
            boxes, np.stack([own, 1 - own, own], axis=1), IMAGE).reshape(
                3, batch, IMAGE, 2)
    else:
        targets = np.eye(2, dtype=np.float32)[
            rng.integers(0, 2, size=(3, batch))]
    mask = np.ones(batch, np.float32)
    if batch > 2:
        mask[-1] = 0.0
    permuted = np.append(rng.permutation(batch - 1), batch - 1) \
        if batch > 2 else rng.permutation(batch)
    model = trainer.build_model().reset_parameters(
        torch.Generator().manual_seed(SEED))
    init = model.state_dict()
    names = [n for n, _ in model.named_parameters()]
    by_gradient = [n for n in names if n.startswith(BY_GRADIENT[name])]
    limit = TRAIN_STEP_ATOL["params"]
    if detector:
        step, _ = make_detector_steps(conf.fl_gamma, conf.fl_alpha)
    else:
        step, _ = make_train_step(trainer.loss_fn, dropout_active=False,
                                  target_mode=trainer.spec.target_mode,
                                  bn_mask_rows="batch")

    def build(dev, dtype):
        model = trainer.build_model()
        model.load_state_dict(init)
        return model.to(device=dev, dtype=dtype)

    def batch_of(k, dev, dtype, rows=slice(None)):
        return [torch.from_numpy(a).to(device=dev, dtype=dtype)
                for a in (images[k][rows], targets[k][rows], mask[rows])]

    def run(dev, dtype, rows=slice(None)):
        model = build(dev, dtype)
        state = TrainState(model, make_optimizer(
            model.parameters(), conf.optimizer,
            learning_rate=conf.learning_rate, weight_decay=conf.weight_decay,
            clip_grad=bool(conf.get("clip_grad")), clip_val=conf.clip_val),
            torch.Generator(device=dev))
        losses, params = [], []
        for k in range(3):
            losses.append(float(step(state, *batch_of(k, dev, dtype, rows))))
            params.append(snapshot(model.state_dict()))
        return losses, params

    def gradients(dev, dtype):
        out = []
        for k in range(3):
            model = build(dev, dtype)
            state = TrainState(model, GradientsOnly(model),
                               torch.Generator(device=dev))
            step(state, *batch_of(k, dev, dtype))
            out.append({n: p.grad.detach().to("cpu", torch.float64)
                        for n, p in model.named_parameters()
                        if n in by_gradient})
        return out

    fields = {"atol": TRAIN_STEP_ATOL, "batch": batch, "pad_rows":
              int((mask == 0).sum()), "by_gradient": {}}
    failed = []
    exact = gradients("cpu", torch.float64)
    card = gradients(device, torch.float32)
    for n in by_gradient:
        scale = max(float(g[n].abs().max()) for g in exact)
        check = fields["by_gradient"][n] = {
            "scale": scale,
            "grad_err_device": [float((card[k][n] - exact[k][n]).abs().max())
                                / scale for k in range(3)],
            "controls": [float(g[n].abs().max()) / scale for g in exact]
            + [float((exact[k][n] - exact[(k + 1) % 3][n]).abs().max())
               / scale for k in range(3)]}
        if min(check["controls"]) <= TRAIN_STEP_ATOL["grad"]:
            raise AssertionError("{}'s gradient limit would pass a zero or "
                                 "another batch's gradient".format(n))
        if max(check["grad_err_device"]) > TRAIN_STEP_ATOL["grad"]:
            failed.append("{} gradient {}".format(
                n, check["grad_err_device"]))
    for dtype_name, dtype in (("float64", torch.float64),
                              ("float32", torch.float32)):
        f32 = dtype == torch.float32
        cpu_losses, cpu_steps = run("cpu", dtype)
        dev_losses, dev_steps = run(device, dtype)
        held = [n for n in cpu_steps[0] if not (f32 and n in by_gradient)]
        loss_err = float(np.max(np.abs(np.subtract(dev_losses, cpu_losses))))
        over = [elements_over(d, c, held, limit)
                for d, c in zip(dev_steps, cpu_steps)]
        record = fields[dtype_name] = {
            "losses_device": dev_losses, "losses_cpu": cpu_losses,
            "max_abs_loss": loss_err,
            "max_abs_params_by_step": [max(float((d[n] - c[n]).abs().max())
                                           for n in held)
                                       for d, c in zip(dev_steps, cpu_steps)],
            "over_atol_by_step": over}
        if loss_err > TRAIN_STEP_ATOL["loss"] or any(over):
            failed.append("{}: loss {}, over {}".format(dtype_name, loss_err,
                                                       over))
        moved = {n: float((cpu_steps[-1][n] - init[n].double()).abs().max())
                 for n in held}
        fault = max(moved, key=moved.get)
        planted = dict(dev_steps[-1])
        planted[fault] = init[fault].double()
        record["planted"] = {"fault": fault + " not updated", "over_atol":
                             sum(elements_over(planted, cpu_steps[-1], held,
                                               limit).values())}
        if not record["planted"]["over_atol"]:
            raise AssertionError("the {} check would pass {} left at its "
                                 "init".format(dtype_name, fault))
        if f32:
            perm_losses, perm_steps = run("cpu", dtype, rows=permuted)
            spread = [elements_over(p, c, held, limit)
                      for p, c in zip(perm_steps, cpu_steps)]
            record["cpu_rows_permuted_over_atol"] = spread
            if any(spread) or np.max(np.abs(np.subtract(
                    perm_losses, cpu_losses))) > TRAIN_STEP_ATOL["loss"]:
                raise AssertionError("the float32 check fails the CPU "
                                     "against itself: {}".format(spread))
    if failed:
        emit("card_vs_cpu_failed", network=name, **fields)
        raise AssertionError("{} card vs CPU: {}".format(
            name, "; ".join(failed)))
    return fields


def two_d_graph_run(workdir, device, name):
    """``run(graphs, dtype, dropout)`` for ``graph_vs_eager``: GRAPH_STEPS
    train steps of 2D network ``name`` from fold 0's state over batches
    gathered once from ``two_d_datasets``' train images (the last with
    pad rows), each ProtoPNet stage in turn, then an eval pass over the
    same batches; (losses, state, eval outputs)."""
    import torch

    from deepards_tpu_torch.train.protopnet_trainer import STAGES

    trainer = two_d_trainer(name, "cpu")
    batch = trainer.conf.batch_size
    n = GRAPH_STEPS * batch
    # 10 patients (5 a class for 5 folds), 8 of them in fold 0's train
    # split: at least n images
    ds, _ = two_d_datasets(trainer, workdir, 10, 5 * -(-n // 40), SEED + 32)
    idx = ds.current_indices()[:n]
    host = [two_d_batch(trainer, ds.gather(idx[k * batch:(k + 1) * batch]))
            for k in range(GRAPH_STEPS)]
    host[-1]["mask"][-1] = 0.0  # a pad row in the last batch
    stages = STAGES if trainer.spec.trainer == "protopnet" else ("train",)

    def run(graphs, dtype, dropout):
        trainer = two_d_trainer(name, device, "--compute-dtype", dtype)
        state = trainer.new_state(0)
        runners = two_d_runners(trainer, state, ds, dropout,
                                graphs and trainer.device.type == "cuda")
        losses, outs = [], []
        for stage in stages:
            for b in host:
                for key, value in b.items():
                    runners[stage].inputs[key].copy_(value.to(trainer.device))
                losses.append(runners[stage].train().clone())
        evaluator = runners[stages[-1]]
        for b in host:
            for key, value in b.items():
                evaluator.inputs[key].copy_(value.to(trainer.device))
            outs.append(evaluator.eval()[1].clone())
        return torch.stack(losses), state, torch.stack(outs)

    return run


def two_d_numbers(workdir, device, name):
    """The bf16 graphed step of 2D network ``name`` at full width and its
    batch (time, device time, kernels, idle share; the eval step too), the
    runner's build seconds and the peak memory above what was allocated
    before it, then one host epoch over fold 0's train split of
    MEASURE_PATIENTS x MEASURE_IMAGES_EACH images (the network's
    transforms, FFT channels, patho mix or splices): images/s, and the
    seconds spent in ``gather`` (normalization, filter, transforms; on the
    prefetch thread, beside the card's work) and their share of the
    epoch."""
    import torch

    trainer = two_d_trainer(name, device)
    ds, _ = two_d_datasets(trainer, workdir, MEASURE_PATIENTS,
                           MEASURE_IMAGES_EACH, SEED + 33)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    baseline = torch.cuda.memory_allocated()
    t0 = time.perf_counter()
    state = trainer.new_state(0)
    runners = two_d_runners(trainer, state, ds)
    torch.cuda.synchronize()
    build_seconds = time.perf_counter() - t0
    batch = trainer.conf.batch_size
    first = two_d_batch(trainer, ds.gather(ds.current_indices()[:batch]))
    ppnet = trainer.spec.trainer == "protopnet"
    for runner in runners.values():
        for key, value in first.items():
            runner.inputs[key].copy_(value)
    out = {"batch": batch, "compute_dtype": "bfloat16",
           "runner_build_seconds": build_seconds}
    for stage, runner in runners.items():
        out[stage if ppnet else "train"] = step_profile(runner.train,
                                                        **NEW_DEPTH["reps"])
    out["eval"] = step_profile(runners["last" if ppnet else "train"].eval,
                               **NEW_DEPTH["reps"])
    gather, spent = ds.gather, [0.0]

    def timed_gather(*args, **kwargs):
        t = time.perf_counter()
        got = gather(*args, **kwargs)
        spent[0] += time.perf_counter() - t
        return got

    ds.gather = timed_gather
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    if ppnet:
        losses = trainer._host_ppnet_steps(runners["joint"], ds)
    elif trainer.spec.kind == "detector":
        losses = trainer.run_detector_train_epoch(runners["train"], ds)
    else:
        trainer.run_train_epoch(runners["train"], ds, 0, 1)
        losses = torch.tensor(trainer.results.get_meter("loss", 0).values)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    images = len(losses) * batch
    if not torch.isfinite(losses).all():
        raise AssertionError("{} host epoch: losses {}".format(name, losses))
    out.update({
        "epoch_steps": len(losses), "epoch_images": images,
        "epoch_seconds": seconds, "images_per_s": images / seconds,
        "gather_seconds": spent[0], "gather_share": spent[0] / seconds,
        "peak_memory_bytes": torch.cuda.max_memory_allocated() - baseline,
        "memory_allocated_before_bytes": baseline})
    step = out["joint" if ppnet else "train"]
    print("numbers {}: {} ms a step, {} ms on the device, idle {}, {} "
          "images/s, gather share {}".format(
              name, step["ms"], step["device_ms"], step["device_idle_share"],
              out["images_per_s"], out["gather_share"]), flush=True)
    return out


@contextlib.contextmanager
def runner_log(log):
    """Append (graphed, device) of every ``StepRunner`` built in the scope
    to ``log``."""
    from deepards_tpu_torch.train.steps import StepRunner

    init = StepRunner.__init__

    def logged(self, state, *args, **kwargs):
        init(self, state, *args, **kwargs)
        log.append((self.graphs is not None,
                    next(state.model.parameters()).device.type))

    StepRunner.__init__ = logged
    try:
        yield log
    finally:
        StepRunner.__init__ = init


def phase_two_d(workdir, device="cuda"):
    """Each 2D network (TWO_D_FLAGS, ``two_d_path``)."""
    return counted_phase("two_d", TWO_D_FLAGS, two_d_path, workdir, device)


def two_d_path(workdir, name, device="cuda"):
    """2D network ``name`` trained through the CLI (cnn_linear_2d: every
    fold, 2 epochs; its FFT variant every fold, 1 epoch; the others fold
    0: the 2x1d 1 epoch, protopnet_2d every stage and one push, the
    detector 2 epochs), every step of it a graph replay on the card;
    cnn_linear_2d's fold-0 checkpoint through ``cli.predict`` against the
    trainer's eval; 3 full-width steps held against the CPU (a ProtoPNet
    stage 1, and its push); graphed steps held to eager ones; on the card
    the numbers.  Returns (fields, failures) of ``run_stages``."""
    epochs, extra = {
        "cnn_linear_2d": (2, ()), "cnn_linear_2d_fft": (1, ()),
        "cnn_linear_2x1d": (1, ("--only-fold", "0")),
        "protopnet_2d": (2, ("--only-fold", "0", *PPNET_2D_CUT)),
        "retinanet_2d": (2, ("--only-fold", "0"))}[name]
    fold = {}

    def train(fields):
        fields["cut"] = ["--epochs", str(epochs), *extra]
        log = []
        with runner_log(log):
            if name == "retinanet_2d":
                trainer, fold["dir"], fields["run"] = train_detector(
                    workdir, device, name, epochs, extra)
            else:
                trainer, fold["dir"], fields["run"] = train_config(
                    workdir, device, name, epochs, list(extra),
                    None if "--only-fold" not in extra else (0,))
        fold["trainer"] = trainer
        model = trainer.final_state.model
        fields["run"].update({
            "base_network": trainer.conf.base_network,
            "input_channels": model.breath_block.conv0.in_channels,
            "block_kernel": list(model.breath_block.block_kernel),
            "runners_graphed": sum(g for g, _ in log), "runners": len(log)})
        placed = {d for _, d in log} | {p.device.type
                                        for p in model.parameters()}
        if placed != {trainer.device.type} or (
                device == "cuda" and not all(g for g, _ in log)):
            raise AssertionError("runners {} on {}, asked for {}".format(
                log, placed, device))
        if trainer.spec.trainer == "protopnet":
            fields["pushes"] = len(trainer.push_infos)
            if len(trainer.push_infos) != 1 or any(
                    i is None for i in trainer.push_infos[0]):
                raise AssertionError("pushes: {}".format(
                    trainer.push_infos))

    def predict(fields):
        cohort_dir, cohort = config_cohort(workdir, fold["trainer"].conf)
        fields["predict"] = predict_vs_eval(CONFIG_FLAGS[name] + [
            "--data-path", cohort_dir, "--cohort-file", cohort,
            "--only-fold", "0", "--device", device],
            os.path.join(fold["dir"], name + "-fold0"),
            os.path.join(workdir, name))

    stages = [("train", train)]
    if name == "protopnet_2d":
        stages += [("card_vs_cpu", lambda fields: fields.update(
            card_vs_cpu=ppnet_card_vs_cpu(device, name))),
                   ("push_card_vs_cpu", lambda fields: fields.update(
                       push_card_vs_cpu=push_card_vs_cpu(workdir, device,
                                                         name)))]
    elif name != "cnn_linear_2d_fft":
        stages.append(("card_vs_cpu", lambda fields: fields.update(
            card_vs_cpu=two_d_card_vs_cpu(device, name))))
    if name == "cnn_linear_2d":
        stages.append(("predict", predict))
    stages.append(("graph_vs_eager", check_graph_vs_eager(
        workdir, name, device, GRAPH_STEPS)))
    if device == "cuda":
        stages.append(("numbers", lambda fields: fields.update(
            numbers=two_d_numbers(workdir, device, name))))
    return run_stages(name, stages, device)


def train_detector(workdir, device, name, epochs, extra):
    """Detector ``name`` through ``cli.train`` on the config cohort, the
    folds of ``extra``: its train losses, the train and test splits' band
    IoU (in [0, 1]) and the test loss of every epoch, and its
    checkpoint."""
    from deepards_tpu_torch.cli.train import main as train_main
    from deepards_tpu_torch.train import checkpoint as ckpt

    conf = config_conf(name)
    cohort_dir, cohort = config_cohort(workdir, conf)
    results_dir = os.path.join(workdir, name + "_results")
    models_dir = os.path.join(workdir, name + "_models")
    t0 = time.perf_counter()
    trainer = train_main(CONFIG_FLAGS[name] + [
        "--epochs", str(epochs), "--data-path", cohort_dir,
        "--cohort-file", cohort, "--results-dir", results_dir,
        "--save-model", name + ".pt", "--saved-models-dir", models_dir,
        "--device", device] + list(extra))
    seconds = time.perf_counter() - t0
    meters = trainer.results.reporting.meters
    read = {m: meters.get("{}_fold_0".format(m))
            for m in ("loss", "band_iou", "band_iou_test", "test_loss")}
    bad = [m for m, meter in read.items() if meter is None or not len(
        meter.values) or not np.isfinite(meter.values).all()]
    bad += [m for m in ("band_iou", "band_iou_test", "test_loss")
            if m not in bad and len(read[m].values) != epochs]
    bad += [m for m in ("band_iou", "band_iou_test") if m not in bad and
            not all(0.0 <= v <= 1.0 for v in read[m].values)]
    path = os.path.join(models_dir, name + "-fold0")
    if bad or ckpt.load_scaling(path) is None:
        raise AssertionError("{}: meters {} or checkpoint missing".format(
            name, bad))
    return trainer, models_dir, {
        "seconds": seconds, "steps": len(read["loss"].values),
        "last_loss": read["loss"].values[-1],
        **{m: read[m].values for m in ("band_iou", "band_iou_test",
                                       "test_loss")}}


# -- the siamese networks and the remaining backbones -------------------------

# the depth of the siamese and backbones phases: the timed device-cache
# epoch of a siamese network (16 steps of 16); a step's time the median of
# 5, its back-to-back time one run of 20, its profile 2 steps; graphed vs
# eager over 2 steps; the backbones' numbers over 64 windows an epoch, a
# step's time the median of 3, no back-to-back run (senet154's step is
# ~176 ms, device-bound); the senets built with one block a stage (their
# blocks, groups, widths and stem) for card vs CPU, where the CPU's side
# of the full depth would take minutes, and for the deep ones' graphed
# vs eager, whose four runners at full depth took 7-20 s a network
# (float32 with TF32 off, an H100 at 700 W); their numbers at full depth.
# For the whole script's time, the sequence networks' graphed vs eager
# takes "graph_steps" too (8 before), their step profiles and the 2D
# networks' "reps" (20 / 3 / 2 and 20 / 3 / 5 before), the backbones'
# profile one step (2 before).
NEW_DEPTH = {
    "measure_windows": 256,
    "reps": dict(reps=5, b2b_reps=1, profile_reps=2),
    "graph_steps": 2,
    "backbone_numbers": dict(windows=64, reps=3, b2b_reps=0,
                             profile_reps=1),
    "one_block_a_stage": {
        "card_vs_cpu": ("cnn_linear_senet154", "cnn_linear_se_resnet50",
                        "cnn_linear_se_resnext50_32x4d"),
        "graph_vs_eager": tuple("cnn_linear_" + base for base in (
            "senet154", "se_resnet50", "se_resnet101", "se_resnet152",
            "se_resnext50_32x4d", "se_resnext101_32x4d"))},
}


def run_stages(name, stages, device, flags=None, launches=None):
    """Run ``stages`` ([(stage, fn)], each ``fn(fields)`` filling
    ``fields`` and returning failures, or raising one) for ``name`` (a
    network, whose flags the fields name unless ``flags`` are given),
    timing each on the host's clock; a stage that fails leaves the next
    ones to run.  With ``launches`` (a dict), each stage's DTW launches go
    into it by stage: counted from 0 just before the stage and read just
    after, or the stage's own count where it leaves one in
    ``fields[stage]["launches"]`` (a stage that checks or times the
    kernel after its path).  Returns (fields, failures)."""
    import deepards_tpu_torch.ops.dtw as dtw_ops

    fields = {"card": nvidia_smi_line() if device == "cuda" else None,
              "flags": CONFIG_FLAGS[name] if flags is None else flags,
              "seconds": {}}
    failed = []
    for stage, fn in stages:
        t0 = time.perf_counter()
        if launches is not None:
            dtw_ops.launches = 0
        try:
            failures = fn(fields) or ()
        except AssertionError as e:
            failures = [str(e)]
        failed += ["{} {}: {}".format(name, stage, f) for f in failures]
        fields["seconds"][stage] = time.perf_counter() - t0
        if launches is not None:
            out = fields.get(stage)
            launches[stage] = out["launches"] if isinstance(out, dict) \
                and "launches" in out else dtw_ops.launches
    fields["phase_seconds"] = sum(fields["seconds"].values())
    print("{}: {} s {}".format(name, fields["phase_seconds"],
                               fields["seconds"]), flush=True)
    return fields, failed


def counted_phase(phase, names, path, workdir, device):
    """``path(workdir, name, device)`` for each of ``names``, its DTW
    launches counted from 0 just before it and read just after: one JSON
    line a network.  Returns {network: launches}."""
    import deepards_tpu_torch.ops.dtw as dtw_ops
    import deepards_tpu_torch.ops.lstm as lstm_ops

    launches, failed = {}, []
    for name in names:
        dtw_ops.launches = 0
        lstm_before = lstm_ops.launches
        fields, failures = path(workdir, name, device)
        launches[name] = dtw_ops.launches
        LSTM_LAUNCHES[name] = lstm_ops.launches - lstm_before
        emit(phase, network=name, dtw_launches=launches[name],
             lstm_launches=LSTM_LAUNCHES[name], **fields)
        failed += failures
    if failed:
        raise AssertionError("{}: {}".format(phase, "; ".join(failed)))
    return launches


def check_card_vs_cpu(name, device):
    def stage(fields):
        fields["card_vs_cpu"] = train_card_vs_cpu(device, name)
    return stage


def check_graph_vs_eager(workdir, name, device,
                         steps=NEW_DEPTH["graph_steps"]):
    def stage(fields):
        fields["graph_vs_eager"], failed = graph_vs_eager(
            workdir, device, name, steps)
        return failed
    return stage


def phase_siamese(workdir, device="cuda"):
    """The three twin networks, then siamese_pretrained with each time
    layer from siamese_cnn_linear's checkpoint (``siamese_path``)."""
    return counted_phase("siamese", SIAMESE_FLAGS, siamese_path, workdir,
                         device)


def siamese_path(workdir, name, device="cuda"):
    """A twin network trained through the CLI (1 epoch over the ``main``
    holdout, ``--save-model``), its triplets checked (``triplet_check``),
    3 steps held against the CPU, graphed steps held to eager ones, and on
    the card the numbers.  siamese_pretrained: trained through the CLI
    (fold 0, 1 epoch) from siamese_cnn_linear's checkpoint
    (``--load-base-network``), held against the CPU, graphed against
    eager, its checkpoint served and predicted against the trainer."""
    pretrained = name.startswith("siamese_pretrained")
    models = {}

    def train(fields):
        extra = []
        if pretrained:
            extra = ["--load-base-network", os.path.join(
                workdir, "siamese_cnn_linear_models", "siamese_cnn_linear"),
                "--only-fold", "0"]
        trainer, models["dir"], fields["run"] = train_config(
            workdir, device, name, 1, extra, folds=(0,))
        models["trainer"] = trainer
        fields["run"]["cut"] = extra[2:]
        if not pretrained:
            fields["run"]["test_loss"] = trainer.results.get_meter(
                "test_loss", 0).values

    stages = [("train", train)]
    if not pretrained:
        stages.append(("triplets", lambda fields: fields.update(
            triplets=triplet_check(workdir, name))))
    stages.append(("graph_vs_eager", check_graph_vs_eager(workdir, name,
                                                          device)))
    if pretrained:
        def serve(fields):
            fields["train_to_serve"] = train_to_serve(
                models["trainer"], models["dir"], device, name, fold=0)

        def predict(fields):
            cohort_dir, cohort = config_cohort(workdir,
                                               models["trainer"].conf)
            fields["predict"] = predict_vs_eval(
                CONFIG_FLAGS[name] + [
                    "--data-path", cohort_dir, "--cohort-file", cohort,
                    "--only-fold", "0", "--device", device],
                os.path.join(models["dir"], name + "-fold0"),
                os.path.join(workdir, name))

        stages += [("serve", serve), ("predict", predict)]
    elif device == "cuda":
        stages.append(("numbers", lambda fields: fields.update(
            numbers=siamese_numbers(workdir, device, name))))
    # last: the worker computes the CPU's side meanwhile
    stages.append(("card_vs_cpu", check_card_vs_cpu(name, device)))
    return run_stages(name, stages, device)


def triplet_check(workdir, name):
    """An epoch's train triplets of the siamese dataset over the phase's
    cohort: each positive a later window of its anchor's patient, the
    first after it, and each negative another patient's window.  Planted:
    a negative drawn from the anchor's own patient must fail it."""
    from deepards_tpu_torch.data.siamese_dataset import SiameseWindowDataset

    conf = config_conf(name)
    cohort_dir, cohort = config_cohort(workdir, conf)
    ds = SiameseWindowDataset(cohort_dir, 1, conf.n_sub_batches,
                              conf.dataset_type, cohort, train=True,
                              seed=conf.get("seed") or 42)
    patient = ds.base.cache.patient_idx.tolist()
    # each window's next window of its patient in the cache, from the end
    following, last = {}, {}
    for j in range(len(patient) - 1, -1, -1):
        following[j] = last.get(patient[j])
        last[patient[j]] = j
    anchor, positive, negative = ds.sample_triplet_indices(
        np.arange(len(ds)))

    def violations(neg):
        return sum(following[a] != p for a, p in zip(anchor.tolist(),
                                                    positive.tolist())) + \
            sum(patient[n] == patient[a] for a, n in zip(anchor.tolist(),
                                                          neg.tolist()))

    planted = negative.copy()
    planted[0] = positive[0]
    fields = {"triplets": len(anchor),
              "patients": len({patient[a] for a in anchor.tolist()}),
              "violations": violations(negative),
              "planted": "a negative from the anchor's own patient",
              "planted_violations": violations(planted)}
    if fields["violations"] or not fields["planted_violations"]:
        raise AssertionError("{} triplets: {}".format(name, fields))
    return fields


def siamese_fold(name, workdir, device, graphs, dtype, dropout):
    """A ``SiameseTrainer`` of ``name``'s flags with fold 0's state built
    without a cohort, and a ``StepRunner`` of its steps over unit scaling:
    CUDA-graph replays with ``graphs`` on the card, else eager."""
    import torch

    from deepards_tpu_torch.data.pipeline import transform_batch
    from deepards_tpu_torch.train.siamese_trainer import (
        SiameseTrainer,
        make_siamese_steps,
    )
    from deepards_tpu_torch.train.steps import StepRunner

    conf = config_conf(name, "--device", device, "--results-dir",
                       os.path.join(workdir, "measure"), "--compute-dtype",
                       dtype)
    trainer = SiameseTrainer(conf, verbose=False)
    trainer.n_sub_batches = conf.n_sub_batches
    state = trainer.new_state(0)
    zero = torch.zeros(1, device=trainer.device)
    one = torch.ones(1, device=trainer.device)
    train_step, eval_step = make_siamese_steps(
        lambda d: transform_batch(d, zero, one), trainer.compute_dtype,
        dropout)
    shape = (conf.batch_size, conf.n_sub_batches, C, L)
    extra = {key: torch.zeros(shape, device=trainer.device)
             for key in ("positive", "negative")}
    runner = StepRunner(state, train_step, eval_step, shape,
                        graphed=graphs and trainer.device.type == "cuda",
                        extra_inputs=extra)
    return trainer, runner


def random_triplets(rng, n, conf):
    """A stand-in for a siamese dataset over ``n`` random windows, and n
    triplets of random indices into it."""
    from types import SimpleNamespace

    ds = random_cache(rng, n, conf)
    ds.cache.data[:] = make_windows(rng, n, conf.n_sub_batches)
    return (SimpleNamespace(base=ds),
            tuple(rng.integers(0, n, size=n) for _ in range(3)))


def siamese_graph_run(workdir, device, name, rng, steps=GRAPH_STEPS):
    """``run(graphs, dtype, dropout)`` for ``graph_vs_eager``: ``steps``
    train steps of random triplets from fold 0's state, then an eval pass
    over the same triplets; (losses, state, eval outputs)."""
    conf = config_conf(name)
    view, triplets = random_triplets(rng, steps * conf.batch_size, conf)

    def run(graphs, dtype, dropout):
        trainer, runner = siamese_fold(name, workdir, device, graphs, dtype,
                                       dropout)
        losses, _ = trainer.triplet_steps(runner, view, triplets, True)
        _, outs = trainer.triplet_steps(runner, view, triplets, False)
        return losses, runner.state, outs

    return run


def siamese_numbers(workdir, device, name):
    """The bf16 graphed train and eval steps (dropout on) of a siamese
    network, and an epoch of NEW_DEPTH["measure_windows"] random triplets
    gathered
    on the card: windows/s counts anchors (each with its positive and its
    negative).  The build time and the peak memory cover the fold's state
    and the runner (warm-up, captures)."""
    import torch

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    baseline = torch.cuda.memory_allocated()
    t0 = time.perf_counter()
    trainer, runner = siamese_fold(name, workdir, device, True, "bfloat16",
                                   True)
    torch.cuda.synchronize()
    build_seconds = time.perf_counter() - t0
    conf = trainer.conf
    view, triplets = random_triplets(np.random.default_rng(SEED + 3),
                                     NEW_DEPTH["measure_windows"], conf)
    trainer.triplet_steps(runner, view, tuple(t[:conf.batch_size]
                                              for t in triplets), True)
    out = {"batch": conf.batch_size, "compute_dtype": "bfloat16",
           "step": step_profile(runner.train, **NEW_DEPTH["reps"]),
           "eval": step_profile(runner.eval, **NEW_DEPTH["reps"])}
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    trainer.triplet_steps(runner, view, triplets, True)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    windows = NEW_DEPTH["measure_windows"]
    out.update(epoch_windows=windows, epoch_seconds=seconds,
               windows_per_s=windows / seconds,
               runner_build_seconds=build_seconds,
               peak_memory_bytes=torch.cuda.max_memory_allocated()
               - baseline)
    print("numbers {}: {} ms a step, {} ms on the device, {} kernels, "
          "{} windows/s".format(name, out["step"]["ms"],
                                out["step"]["device_ms"],
                                out["step"]["launches"],
                                out["windows_per_s"]), flush=True)
    return out


@contextlib.contextmanager
def one_block_a_stage(name, stage):
    """Within the scope, the senet of network ``name`` is built with one
    block a stage where NEW_DEPTH cuts ``stage`` so (no change else).
    Yields the blocks a stage, or None."""
    from deepards_tpu_torch.models import registry, senet1d

    if name not in NEW_DEPTH["one_block_a_stage"][stage]:
        yield None
        return
    flags = CONFIG_FLAGS[name]
    base = flags[flags.index("--base-network") + 1]
    full = registry.BASE_NETWORKS[base]
    # the constructor is a partial of SENet1D: its blocks a stage second
    ctor = getattr(senet1d, base)
    blocks = (1, 1, 1, 1)
    registry.BASE_NETWORKS[base] = lambda conf, c: senet1d.SENet1D(
        ctor.args[0], blocks, *ctor.args[2:], in_channels=c,
        **ctor.keywords)
    try:
        yield blocks
    finally:
        registry.BASE_NETWORKS[base] = full


def phase_backbones(workdir, device="cuda"):
    """Each name of BACKBONE_FLAGS (``backbone_path``)."""
    return counted_phase("backbones", BACKBONE_FLAGS, backbone_path,
                         workdir, device)


def backbone_path(workdir, name, device="cuda"):
    """A network of BACKBONE_FLAGS: the names of BACKBONE_BY_BLOCK trained
    through the CLI (fold 0, 1 epoch; ProtoPNet over vgg11_bn through one
    stage and a push), every step a graph replay on the card, and the
    ones of them under cnn_linear and the autoencoder held against the
    CPU for 3 steps; every name's graphed steps held to eager ones; on
    the card the numbers of the bf16 graphed step."""
    ppnet = name == "protopnet_vgg11_bn"

    def train(fields):
        cut = PPNET_VGG_CUT if ppnet else []
        trainer, _, fields["run"] = train_config(
            workdir, device, name, 1, ["--only-fold", "0"] + cut, folds=(0,))
        fields["run"]["cut"] = ["--only-fold", "0"] + cut
        model = trainer.final_state.model
        fields["run"]["params"] = sum(p.numel() for p in model.parameters())
        if ppnet:
            pushes = trainer.push_infos
            fields["run"]["pushes"] = len(pushes)
            if len(pushes) != 1 or any(i is None for i in pushes[0]):
                return ["pushes {}".format(pushes)]

    def graphs(fields):
        if not ppnet:
            with one_block_a_stage(name, "graph_vs_eager") as blocks:
                failed = check_graph_vs_eager(workdir, name, device)(fields)
            fields["graph_vs_eager"]["blocks_a_stage"] = blocks
            return failed
        fields["graph_vs_eager"], failed, runners = ppnet_graph_vs_eager(
            workdir, device, name)
        if device == "cuda":
            fields["numbers"] = {
                "batch": BATCH, "compute_dtype": "bfloat16",
                **{stage: step_profile(runner.train, **NEW_DEPTH["reps"])
                   for stage, runner in runners.items()}}
        return failed

    def card_vs_cpu(fields):
        with one_block_a_stage(name, "card_vs_cpu") as blocks:
            check_card_vs_cpu(name, device)(fields)
        fields["card_vs_cpu"]["blocks_a_stage"] = blocks

    stages = []
    if name in BACKBONE_BY_BLOCK:
        stages.append(("train", train))
    stages.append(("graph_vs_eager", graphs))
    if device == "cuda" and not ppnet:
        stages.append(("numbers", lambda fields: fields.update(
            numbers=train_numbers(workdir, device, name,
                                  (("graphed", True),),
                                  **NEW_DEPTH["backbone_numbers"]))))
    if name in BACKBONE_BY_BLOCK and not ppnet:
        # last: the worker computes the CPU's side meanwhile
        stages.append(("card_vs_cpu", card_vs_cpu))
    return run_stages(name, stages, device)


REAL_PATIENT_WINDOWS = 1440  # a 24 h patient: 28,800 breaths of S = 20
DTW_KEEP = 256  # the real-size patient's pairs held to dtw_reference
ANALYTICS_KFOLDS = 5  # config 1's folds, 1 epoch each (its yml: 10)
# the DTW run's breaths a patient: twice the smoke cohort's, whose last
# fold tests one patient, so that this run's tests two and a row can be
# moved between them
DTW_COHORT_BREATHS = 800
CAM_KFOLDS = 2  # the cam studies' runs: 2 folds x 1 epoch
CAM_SAMPS = 16  # the cam CLIs' -n: windows a fold
STUDY_ATOL = 1e-5  # cams (of max(1, |x|)), outputs and splice logits


def analytics_run(cohort, device, flags, name, results_dir, models_dir):
    """``cli.train`` of config 1 and ``flags`` (1 epoch) on ``cohort``
    (its directory and file), its checkpoints ``<name>-fold<k>`` under
    ``models_dir``: the trainer."""
    from deepards_tpu_torch.cli.train import main as train_main

    return train_main(CONFIG1_FLAGS + flags + [
        "--data-path", cohort[0], "--cohort-file", cohort[1],
        "--epochs", "1", "--results-dir", results_dir, "--save-model",
        name + ".pt", "--saved-models-dir", models_dir, "--device", device])


def dtw_frames_vs_cpu(got, results, dataset, root, device):
    """``got`` ({patient: DTWFrame}, the card's) against the same rows
    through ``analyze_patient`` on the CPU (``dtw_reference``): index, hour
    and dtw exactly equal.  Planted, each must fail: one patient's hours
    shifted by one breath, and one prediction row given to another
    patient (the hook run again on the device with that row moved)."""
    from deepards_tpu_torch.eval import plots

    want = plots.perform_dtw_preprocessing(
        results, dataset, os.path.join(root, "cpu_cache"), device="cpu")

    def misses(frames):
        if list(frames) != list(want):
            return ["patients {} against {}".format(list(frames),
                                                    list(want))]
        out = []
        for pt, frame in want.items():
            for field in ("index", "hour", "dtw"):
                a, b = getattr(frames[pt], field), getattr(frame, field)
                if a.shape != b.shape or not np.array_equal(
                        a, b, equal_nan=field != "index"):
                    out.append("{} {}".format(pt, field))
        return out

    failed = misses(got)
    patients = list(want)
    rows = [dict(r) for r in results.pred_to_hour_frame]
    first = [i for i, r in enumerate(rows) if r["patient"] == patients[0]]
    if len(patients) < 2 or len(first) < 2:
        raise AssertionError(
            "the hook saw {} test patients, the first with {} rows: moving "
            "a row between two of them needs 2 and 2".format(
                len(patients), len(first)))
    shifted = dict(got)
    shifted[patients[0]] = got[patients[0]]._replace(
        hour=np.roll(got[patients[0]].hour, 1))
    # the first patient's last row given to the second: both keep their
    # place in the order, so only the frames' contents can catch it
    rows[first[-1]]["patient"] = patients[1]
    moved = plots.perform_dtw_preprocessing(
        types.SimpleNamespace(pred_to_hour_frame=rows), dataset,
        os.path.join(root, "moved_cache"), device=device)
    planted = {"hours_shifted_a_breath": misses(shifted),
               "row_given_to_another_patient": misses(moved)}
    if list(moved) != patients:
        raise AssertionError("the moved row changed the patients: {}".format(
            list(moved)))
    if not all(planted.values()):
        raise AssertionError("the DTW frame check would pass {}".format(
            [k for k, v in planted.items() if not v]))
    return {"patients": len(want), "breaths": sum(len(f.index)
                                                  for f in want.values()),
            "misses": failed, "planted": planted}


@contextlib.contextmanager
def timing_dtw_chunks(timer):
    """``timer`` records every chunk of ``dtw.lib.batched_dtw_pairs``
    while the context lasts (its module-level ``TIMER``)."""
    from deepards_tpu_torch.dtw import lib

    lib.TIMER = timer
    try:
        yield timer
    finally:
        lib.TIMER = None


def dtw_hook_kernel_ms(results, dataset, device, workdir, reps=10):
    """The DTW kernel over ``reps`` more runs of the hook on the same
    rows, each with a fresh cache: its launches a run, its device ms a
    run by torch.profiler (None, with the profiler's error under
    ``kernel_ms_not_measured``, where it recorded no DTW kernel), and its
    ms a run between CUDA events around each call (host time
    included)."""
    import deepards_tpu_torch.ops.dtw as dtw_ops
    from deepards_tpu_torch.dtw.lib import SweepTimer
    from deepards_tpu_torch.eval import plots
    from deepards_tpu_torch.ops.dtw_timing import device_ms

    calls, timers = [], []

    def hook():
        launched = dtw_ops.launches
        with timing_dtw_chunks(SweepTimer()) as timer:
            plots.perform_dtw_preprocessing(
                results, dataset, tempfile.mkdtemp(dir=workdir),
                device=device)
        timers.append(timer)
        calls.append(dtw_ops.launches - launched)

    out = {}
    try:
        out["kernel_ms"] = device_ms(hook, reps=reps) * calls[-1]
    except RuntimeError as e:
        out.update(kernel_ms=None, kernel_ms_not_measured=str(e))
    out.update(launches_a_run=calls[-1], kernel_call_ms=float(np.median(
        [sum(t.kernel_ms) for t in timers[1:]])))
    return out


def real_size_patient(workdir, device, per_cell, n_windows, s=S):
    """One seeded patient of ``n_windows`` windows of ``s`` breaths through
    ``perform_dtw_preprocessing``: seconds split into the host's breath
    lists and frames, ``_pad_pairs``, the copy and the kernel calls (CUDA
    events around them, host time included), pairs/s, the kernel's own
    time (torch.profiler) and its share of the bound, and DTW_KEEP of its
    pairs held exactly to ``dtw_reference``."""
    import torch

    import deepards_tpu_torch.ops.dtw as dtw_ops
    from deepards_tpu_torch.dtw.lib import SweepTimer, _pad_pairs
    from deepards_tpu_torch.eval import plots
    from deepards_tpu_torch.ops.dtw import dtw_reference

    root = os.path.join(workdir, "real_size")
    os.makedirs(root)
    data = make_windows(np.random.default_rng(SEED + 12), n_windows, s)
    ds = cohort_dataset(root, data, [1], n_windows)
    truth = ds.get_ground_truth()
    rows = [{"index": int(i), "pred": 1, "hour": float(h),
             "patient": str(p), "y": int(y)}
            for i, h, p, y in zip(truth.index, truth.hour, truth.patient,
                                  truth.y)]
    launched = dtw_ops.launches
    t0 = time.perf_counter()
    with timing_dtw_chunks(SweepTimer(keep=DTW_KEEP)) as timer:
        frames = plots.perform_dtw_preprocessing(
            types.SimpleNamespace(pred_to_hour_frame=rows), ds,
            os.path.join(root, "dtw_cache"), device=device)
    if device != "cpu":
        torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    # the path's launches, read before the kernel is timed below
    launches = dtw_ops.launches - launched
    breaths = n_windows * s
    pairs = 3 * (breaths - 3)
    a, b, la, lb, d = timer.kept
    want = dtw_reference(a, b, la, lb)
    frame = frames[str(truth.patient[0])]
    fields = {
        "windows": n_windows, "breaths": breaths, "pairs": pairs,
        "launches": launches,
        "width": L, "chunks": len(timer.pad_s), "seconds": seconds,
        "pairs_per_s": pairs / seconds, "pad_s": sum(timer.pad_s),
        "copy_s": sum(timer.copy_s),
        "kept_pairs_vs_reference_max_abs": float((d - want).abs().max()),
        "frame_breaths": len(frame.index),
        "finite_scores": int(np.isfinite(frame.dtw).sum())}
    if fields["kept_pairs_vs_reference_max_abs"] != 0.0 or \
            fields["frame_breaths"] != breaths or \
            fields["finite_scores"] != breaths - 3:
        raise AssertionError("the real-size patient: {}".format(fields))
    if device != "cpu":
        from deepards_tpu_torch.ops.dtw import dtw_cuda
        from deepards_tpu_torch.ops.dtw_timing import device_ms

        call_ms = sum(timer.kernel_ms)
        lengths = torch.full((pairs,), L)
        bound = dtw_bound(
            lengths, lengths, per_cell["warp{}".format(-(-L // 32))],
            torch.cuda.get_device_properties(0).multi_processor_count,
            sm_clock_hz())
        # the kernel's own time (torch.profiler): a launch of the path's
        # first chunk (8,192 pairs of 224 padded to width 256, as every
        # chunk is but the last, also padded to 8,192) times the chunks
        flat = data.reshape(-1, L)
        first = [(i, i - k) for i in range(3, len(flat))
                 for k in (1, 2, 3)][:8192]
        chunk = [torch.from_numpy(x).to(device) for x in _pad_pairs(
            [flat[i] for i, _ in first], [flat[j] for _, j in first])]
        kernel_ms = device_ms(lambda: dtw_cuda(*chunk), reps=5) * len(
            timer.pad_s)
        fields.update(
            kernel_call_ms=call_ms, kernel_ms=kernel_ms,
            bound_ms=bound["bound_ms"], bound_by=bound["bound_by"],
            kernel_share_of_bound=bound["bound_ms"] / kernel_ms,
            breath_lists_s=seconds - fields["pad_s"] - fields["copy_s"]
            - call_ms / 1e3)
    return fields


def evaluate_vs_predict(root, cohort, device, models_dir, name, kfolds, nb,
                        results_dir):
    """``cli.evaluate`` over each fold's checkpoint ``<name>-fold<k>``
    twice (two pseudo-epochs, which must be equal), its patients'
    pred_frac against ``cli.predict``'s votes of the same checkpoint
    within PREDICT_ATOL."""
    from deepards_tpu_torch.cli.evaluate import evaluate
    from deepards_tpu_torch.cli.predict import predict
    from deepards_tpu_torch.cli.train import build_parser
    from deepards_tpu_torch.config.config import Configuration
    from deepards_tpu_torch.data.dataset import ARDSRawDataset

    flags = CONFIG1_FLAGS + ["--kfolds", str(kfolds), "--n-sub-batches",
                             str(nb)]
    conf = config_conf("config1", *flags[len(CONFIG1_FLAGS):])
    data = ARDSRawDataset(
        cohort[0], 1, cohort[1], nb, conf.dataset_type, kfold_num=0,
        total_kfolds=kfolds).save(os.path.join(root, "evaluate.npz"))
    models = {k: ["{}-fold{}".format(name, k)] * 2 for k in range(kfolds)}
    t0 = time.perf_counter()
    rows, aggregate, trainer = evaluate(Configuration(overrides=dict(
        conf.conf, train_from_pickle=data, models=models,
        results_dir=results_dir)), device, models_dir)
    seconds = time.perf_counter() - t0
    records = trainer.results.results
    worst, unequal = 0.0, []
    for k in range(kfolds):
        epochs = [{r["patient"]: r["pred_frac"] for r in records
                   if r["fold_num"] == k and r["epoch_num"] == e}
                  for e in (0, 1)]
        if epochs[0] != epochs[1] or not epochs[0]:
            unequal.append(k)
        _, votes = predict(Configuration(build_parser().parse_args(flags + [
            "--train-from-pickle", data, "--only-fold", str(k),
            "--device", device])), os.path.join(models_dir, models[k][0]))
        if sorted(v["patient"] for v in votes) != sorted(epochs[0]):
            unequal.append(k)
            continue
        worst = max(worst, max(abs(v["pred_frac"] - epochs[0][v["patient"]])
                               for v in votes))
    fields = {"folds": rows, "aggregate_rows": len(aggregate or ()),
              "patient_rows": len(records), "seconds": seconds,
              "max_abs_pred_frac_vs_predict": worst, "atol": PREDICT_ATOL}
    if unequal or worst > PREDICT_ATOL or len(rows) != kfolds:
        raise AssertionError("evaluate: pseudo-epochs or patients of folds "
                             "{} unequal, {}".format(unequal, fields))
    return fields


def study_vs_cpu(got, want, two_d):
    """A study's cams card vs CPU: picks and sample indexes equal, outputs
    within STUDY_ATOL, cams within STUDY_ATOL of max(1, |x|) but for at
    most 1% of them (a feature within rounding of 0 passes the head's
    ReLU on one side only, and the cam of that window jumps).  Returns
    (fields, failures)."""
    failed = []
    fields = {"cams": 0, "cams_apart": 0, "max_abs_cam": 0.0,
              "max_abs_output": 0.0}
    for patho in (0, 1):
        if got.seq_idxs[patho] != want.seq_idxs[patho] or [
                tuple(k) for k in got.kfold_idxs[patho]] != [
                tuple(k) for k in want.kfold_idxs[patho]]:
            failed.append("picks of class {}".format(patho))
            continue
        for g, w, go, wo in zip(got.cams[patho], want.cams[patho],
                                got.model_outs[patho], want.model_outs[patho]):
            miss = np.abs(g - w) / np.maximum(1.0, np.abs(w))
            fields["cams"] += 1
            fields["cams_apart"] += int(miss.max() > STUDY_ATOL)
            fields["max_abs_cam"] = max(fields["max_abs_cam"],
                                        float(np.abs(g - w).max()))
            fields["max_abs_output"] = max(fields["max_abs_output"],
                                           float(np.abs(go - wo).max()))
    fields["unnormalized"] = two_d
    if fields["cams_apart"] > 0.01 * fields["cams"]:
        failed.append("{} of {} cams apart".format(fields["cams_apart"],
                                                   fields["cams"]))
    if fields["max_abs_output"] > STUDY_ATOL:
        failed.append("outputs {}".format(fields["max_abs_output"]))
    return fields, failed


def cam_studies(workdir, cohort, device, kfolds, nb, samps, results_dir,
                trainers):
    """``cli.cam_analytics one-d`` over the checkpoints of a 2-fold
    ``--only-fft`` run, ``two-d`` over the same, ``butter`` over those of
    a run through a 0-5 Hz Butterworth filter, each on the card and on the
    CPU (``study_vs_cpu``; the splices' indexes equal and logits within
    STUDY_ATOL; the prototypes within STUDY_ATOL of their scale); cams/s
    of a batch of CAM_BATCH sequences on the card.  The runs' trainers go
    to ``trainers``.  Returns (fields, failures)."""
    from deepards_tpu_torch.cli import cam_analytics
    from deepards_tpu_torch.data.dataset import ARDSRawDataset
    from deepards_tpu_torch.explain import frequency_analytics as fa
    from deepards_tpu_torch.explain.gradcam import UnNormalizedCam

    models_dir = os.path.join(workdir, "cam_models")
    fields, failed = {}, []
    data = {}
    base = ["--kfolds", str(kfolds), "--n-sub-batches", str(nb)]
    for kind, extra in (("fft", ["--only-fft"]),
                        ("butter", ["--butter-low", "0", "--butter-high",
                                    "5"])):
        t0 = time.perf_counter()
        trainers.append(analytics_run(cohort, device, base + extra, kind,
                                      results_dir, models_dir))
        conf = config_conf("config1", *base)
        data[kind] = ARDSRawDataset(
            cohort[0], 1, cohort[1], nb, conf.dataset_type, kfold_num=0,
            total_kfolds=kfolds, only_fft=kind == "fft").save(
                os.path.join(workdir, "cam_{}.npz".format(kind)))
        fields["{}_run_seconds".format(kind)] = time.perf_counter() - t0
    for cmd, kind in (("one-d", "fft"), ("two-d", "fft"),
                      ("butter", "butter")):
        argv = [cmd, "-p", data[kind], "--model-pattern",
                os.path.join(models_dir, kind + "-fold{fold}"), "--folds",
                str(kfolds), "-n", str(samps)]
        if cmd == "butter":
            argv += ["--no-filter-pickle", data[kind], "-lf", "0", "-hf", "5"]
        res, seconds = {}, {}
        for dev in dict.fromkeys((device, "cpu")):
            t0 = time.perf_counter()
            res[dev] = cam_analytics.main(argv + [
                "-o", os.path.join(workdir, "cams", cmd, dev),
                "--device", dev])
            seconds[dev] = time.perf_counter() - t0
        got, want = res[device], res["cpu"]
        study, missed = study_vs_cpu(got["study"], want["study"],
                                     cmd == "two-d")
        study["seconds"] = seconds
        failed += ["{}: {}".format(cmd, m) for m in missed]
        if cmd == "one-d":
            a, b = got["splices"], want["splices"]
            apart = sorted(a) != sorted(b) or any(
                not np.array_equal(a[k], b[k]) for k in
                ("ards_idx", "other_idx", "flipped") if k in b) or any(
                np.abs(a[k] - b[k]).max() > STUDY_ATOL for k in
                ("before_ards_logit", "after_ards_logit") if k in b)
            study["splices"] = len(b.get("ards_idx", ()))
            if apart:
                failed.append("one-d: splices {} against {}".format(a, b))
        if cmd == "butter":
            worst = 0.0
            for key, value in want["prototypes"].items():
                scale = max(1.0, float(np.abs(value).max()))
                worst = max(worst, float(np.abs(
                    got["prototypes"][key] - value).max()) / scale)
            study["prototypes_max_rel"] = worst
            if sorted(got["prototypes"]) != sorted(want["prototypes"]) or \
                    worst > STUDY_ATOL:
                failed.append("butter: prototypes {}".format(worst))
        fields[cmd] = study
    if device != "cpu":
        ds = ARDSRawDataset.from_pickle(data["fft"])
        ds.set_kfold_indexes_for_fold(0)
        model = cam_analytics.models_by_fold(
            "cnn_linear", "densenet18", ds, os.path.join(
                models_dir, "fft-fold{fold}"), 1, device)[0]
        idx = np.resize(ds.current_indices(), fa.CAM_BATCH)
        xs = fa.gather_pipeline(ds)(ds.cache.data[idx])
        gen = UnNormalizedCam(model)
        ms = cuda_ms(lambda: gen.generate_cams_batch(
            xs, np.zeros(len(xs), np.int64)), warmup=1, reps=5)
        fields["cams_per_s"] = {"batch": fa.CAM_BATCH, "ms": ms,
                                "cams_per_s": fa.CAM_BATCH / ms * 1e3}
    return fields, failed


def results_tools(results_dir, trainers):
    """``cli.mean_metrics``, ``cli.visualize_results`` (its meters, no
    figure) and ``cli.find_all_experiments`` over the phase's results:
    each run's AUC by fold and epoch equal to ``eval.metrics.roc_auc`` of
    the same rows, a meters file and a record a run."""
    from deepards_tpu_torch.cli import find_all_experiments as find
    from deepards_tpu_torch.cli import mean_metrics
    from deepards_tpu_torch.cli import visualize_results
    from deepards_tpu_torch.eval.metrics import roc_auc

    files = sorted(glob.glob(os.path.join(results_dir, "*_results_*.json")))
    unequal = []
    for path in files:
        rows = mean_metrics.load_results(path)
        stats = mean_metrics.compute_metrics_from_patient_results(rows)
        for f, e, auc in zip(stats["fold"], stats["epoch"], stats["AUC"]):
            mine = [r for r in rows if r["fold_num"] == f
                    and r["epoch_num"] == e]
            want = roc_auc([r["patho"] for r in mine],
                           [r["pred_frac"] for r in mine])
            if not (auc == want or (np.isnan(auc) and np.isnan(want))):
                unequal.append((os.path.basename(path), f, e))
    best = mean_metrics.main(["--results-dir", results_dir])
    meters = visualize_results.load_meters(results_dir)
    found = find.find_experiments(results_dir)
    starts = sorted(str(t.start_time) for t in trainers)
    fields = {"results_files": len(files), "folds": len(best["fold"]),
              "meters_files": len(meters), "experiments": len(found),
              "auc_rows_unequal": unequal}
    if unequal or len(files) != len(trainers) or sorted(
            r["start_time"] for r in found) != starts or len(meters) != len(
                set(starts)):
        raise AssertionError("results tools: {}".format(fields))
    return fields


def dtw_cohort(workdir):
    """The DTW run's seeded cohort, 10 patients x DTW_COHORT_BREATHS
    breaths: (data path, cohort file)."""
    from deepards_tpu_torch.data.synthetic import generate_cohort

    cohort_dir = os.path.join(workdir, "dtw_cohort")
    return cohort_dir, generate_cohort(
        cohort_dir, n_patients=10, n_breaths_per_patient=DTW_COHORT_BREATHS,
        seed=SEED, subdirs=("all_data",))


def plot_options_run(root, dtw_data, device, kfolds, nb, want):
    """Config 1 through ``cli.train`` with ``--plot-dtw-with-disease
    --plot-tiled-disease-evol`` (the last fold only, 1 epoch, in a
    directory of its own, so its DTW cache starts empty): its DTW frames
    equal ``want`` (the ``--perform-dtw-preprocessing`` run's: the last
    fold's test windows, whatever the predictions), each PNG stage
    refused by name on the card (drawn on the CPU host with matplotlib)
    and its ``.npz`` written.  Returns (fields, failures)."""
    import deepards_tpu_torch.ops.dtw as dtw_ops
    from deepards_tpu_torch.utils import figures

    work = os.path.join(root, "plots")
    os.makedirs(work)
    stages, printed = [], io.StringIO()
    draw = figures.draw_or_refuse

    def recording(stage_list, dev):
        stage_list = list(stage_list)
        stages.extend(path for path, _ in stage_list)
        with contextlib.redirect_stdout(printed):
            return draw(stage_list, dev)

    figures.draw_or_refuse = recording
    try:
        with contextlib.chdir(work):
            trainer = analytics_run(
                dtw_data, device, ["--kfolds", str(kfolds), "--only-fold",
                                   str(kfolds - 1), "--n-sub-batches",
                                   str(nb), "--plot-dtw-with-disease",
                                   "--plot-tiled-disease-evol"],
                "plots", os.path.join(work, "results"),
                os.path.join(work, "models"))
    finally:
        figures.draw_or_refuse = draw
    launches = dtw_ops.launches
    print(printed.getvalue(), end="", flush=True)
    refused = [ln for ln in printed.getvalue().splitlines()
               if " refused: " in ln]
    npz = sorted(glob.glob(os.path.join(work, "prediction_plots", "*.npz")))
    got = trainer.dtw_frames
    unequal = sorted(pt for pt in set(got) | set(want or {}) if want is None
                     or pt not in got or pt not in want or any(
                         not np.array_equal(getattr(got[pt], f),
                                            getattr(want[pt], f),
                                            equal_nan=True)
                         for f in ("index", "hour", "dtw")))
    fields = {"flags": ["--plot-dtw-with-disease",
                        "--plot-tiled-disease-evol", "--only-fold",
                        str(kfolds - 1)],
              "frames": len(got), "frames_unequal": unequal,
              "launches": launches, "png_stages": stages,
              "refused": refused[:4], "npz": len(npz)}
    missed = []
    if unequal:
        missed.append("plot run's DTW frames differ from the DTW run's: "
                      "{}".format(unequal))
    if not stages or len(npz) != len(stages):
        missed.append("{} PNG stages, {} .npz".format(len(stages), len(npz)))
    if device != "cpu" and len(refused) != len(stages):
        missed.append("{} of {} PNG stages refused on the card".format(
            len(refused), len(stages)))
    return fields, missed


def phase_analytics(workdir, device="cuda", per_cell=None,
                    eval_models=None, nb=S, kfolds=ANALYTICS_KFOLDS,
                    cam_kfolds=CAM_KFOLDS, cam_samps=CAM_SAMPS,
                    real_windows=REAL_PATIENT_WINDOWS, cohort=None,
                    dtw_data=None):
    """Training's DTW preprocessing, the frequency cam studies and the
    results tools, at config 1's width:
    ``cli.train --perform-dtw-preprocessing`` (``kfolds`` folds x 1 epoch)
    on ``dtw_data``, its frames held exactly to the CPU's
    (``dtw_frames_vs_cpu``) and its kernel timed; one real-size patient
    (``real_size_patient``); ``cli.evaluate`` over ``eval_models`` (the
    train phase's fold checkpoints, else the DTW run's) against
    ``cli.predict`` (``evaluate_vs_predict``); the cam CLIs card vs CPU
    (``cam_studies``); the results tools over the phase's results
    (``results_tools``).  ``cohort``, ``dtw_data``: (directory, file), by
    default config 1's and ``dtw_cohort``'s.  One JSON line, a stage's
    DTW launches counted from 0 just before it (``run_stages``).  Returns
    the DTW launches by path."""
    import deepards_tpu_torch.ops.dtw as dtw_ops
    from deepards_tpu_torch.eval import plots

    root = os.path.join(workdir, "analytics")
    os.makedirs(root)
    cohort = cohort or config_cohort(workdir, config_conf("config1"))
    dtw_data = dtw_data or dtw_cohort(root)
    results_dir = os.path.join(root, "results")
    models_dir = os.path.join(root, "models")
    launches, trainers = {}, []

    # the hook's arguments, as the trainer passes them
    hook = {}
    traced = plots.perform_dtw_preprocessing

    def recording(results, test_dataset, *args, **kwargs):
        hook.update(results=results, dataset=test_dataset)
        return traced(results, test_dataset, *args, **kwargs)

    def dtw_training(fields):
        plots.perform_dtw_preprocessing = recording
        try:
            with contextlib.chdir(root):
                trainer = analytics_run(
                    dtw_data, device, ["--kfolds", str(kfolds),
                                       "--n-sub-batches", str(nb),
                                       "--perform-dtw-preprocessing"],
                    "dtw", results_dir, models_dir)
        finally:
            plots.perform_dtw_preprocessing = traced
        trainers.append(trainer)
        # the path's launches: the checks' and the profile's below are not
        out = fields["dtw_preprocessing"] = {
            "frames": len(trainer.dtw_frames), "launches": dtw_ops.launches,
            "cut": {"folds": kfolds, "epochs": "10 -> 1"}}
        out["vs_cpu"] = dtw_frames_vs_cpu(
            trainer.dtw_frames, hook["results"], hook["dataset"], root,
            device)
        if device != "cpu":
            out["kernel"] = dtw_hook_kernel_ms(hook["results"],
                                               hook["dataset"], device, root)
        if out["vs_cpu"]["misses"]:
            return ["dtw frames vs the CPU: {}".format(
                out["vs_cpu"]["misses"])]
        return ()

    def plot_training(fields):
        fields["plots"], missed = plot_options_run(
            root, dtw_data, device, kfolds, nb,
            trainers[0].dtw_frames if trainers else None)
        return missed

    def real_size(fields):
        fields["real_size_patient"] = real_size_patient(
            root, device, per_cell, real_windows, nb)

    def evaluate(fields):
        fields["evaluate"] = evaluate_vs_predict(
            root, cohort, device, eval_models or models_dir,
            "config1" if eval_models else "dtw", kfolds, nb,
            os.path.join(root, "evaluate_results"))

    def cams(fields):
        fields["cam_analytics"], missed = cam_studies(
            root, cohort, device, cam_kfolds, nb, cam_samps, results_dir,
            trainers)
        return missed

    def tools(fields):
        fields["results_tools"] = results_tools(results_dir, trainers)

    fields, failed = run_stages(
        "analytics", [("dtw_preprocessing", dtw_training),
                      ("plots", plot_training),
                      ("real_size_patient", real_size),
                      ("evaluate", evaluate), ("cam_analytics", cams),
                      ("results_tools", tools)], device,
        flags=CONFIG1_FLAGS, launches=launches)
    fields["launches_by_path"] = launches
    emit("analytics", **fields)
    if device != "cpu" and not (launches["dtw_preprocessing"]
                                and launches["plots"]
                                and launches["real_size_patient"]):
        failed.append("a DTW path launched no kernel: {}".format(launches))
    if any(launches[k] for k in ("evaluate", "cam_analytics",
                                 "results_tools")):
        failed.append("an analytics CLI launched the dtw kernel: {}".format(
            launches))
    if failed:
        raise AssertionError("; ".join(failed))
    return {"analytics_dtw_preprocessing": launches["dtw_preprocessing"],
            "analytics_plots": launches["plots"],
            "analytics_real_size_patient": launches["real_size_patient"],
            "evaluate": launches["evaluate"],
            "cam_analytics": launches["cam_analytics"],
            "results_tools": launches["results_tools"]}


# the experiment files of benchmark configs 1-5, read through ``-co``
EXPERIMENT_FILES = {
    "config1": "unpadded_centered_nb20_cnn_linear.yml",
    "config2": "padded_breath_by_breath_resnet18.yml",
    "config3": "bm_pretraining_regression.yml",
    "config4": "unpadded_centered_nb20_cnn_lstm.yml",
    "config5": "unpadded_centered_nb20_protopnet.yml",
}
EXPERIMENT_DIR = os.path.join("deepards_tpu", "config", "experiment_files")
EVALUATE_LAYOUT = os.path.join("deepards_tpu", "config", "evaluate_config",
                               "unpadded_centered_nb20_cnn_linear.yml")
# generated configs swept through cli.registry_sweep in the phase: the
# benchmark configs' families, ProtoPNet, lstm_only, a 2D network and a
# similarity-split holdout
SWEEP_FILES = (
    "unpadded_centered_nb20_cnn_linear.yml",
    "padded_breath_by_breath_resnet18.yml",
    "bm_pretraining_regression.yml",
    "unpadded_centered_20_len_sub_batch_cnn_lstm.yml",
    "protopnet_unpadded_centered.yml",
    "lstm_only_experiment_benchmark.yml",
    "unpadded_centered_nb20_cnn_linear_2d_bs2.yml",
    "holdout_with_similarity_split.yml",
)
PICKLE_SHIFTED_ROW = 3  # the planted fault's row: its hours + 1
TRACED_STEPS = 3


@contextlib.contextmanager
def blocked_modules(*names):
    """``import`` of each of ``names`` (and its submodules) raises inside
    the block; the modules loaded before come back after it."""
    saved = {k: sys.modules.pop(k) for k in list(sys.modules)
             if k.split(".")[0] in names}
    for name in names:
        sys.modules[name] = None
    try:
        yield
    finally:
        for name in names:
            sys.modules.pop(name, None)
        sys.modules.update(saved)


def configuration_diff(argv, want_argv):
    """The keys whose values differ between the ``Configuration`` of
    ``cli.train``'s ``argv`` and of ``want_argv`` (a bool flag left unset,
    None, reads as false)."""
    from deepards_tpu_torch.cli.train import build_parser
    from deepards_tpu_torch.config.config import Configuration

    got, want = (Configuration(build_parser().parse_args(a)).conf
                 for a in (argv, want_argv))
    diff = []
    for key in sorted((set(got) | set(want)) - {"config_override"}):
        a, b = got.get(key), want.get(key)
        same = (bool(a) == bool(b) if isinstance(a, bool)
                or isinstance(b, bool) else a == b)
        if not same:
            diff.append(key)
    return diff


def experiment_files_vs_flags(workdir):
    """Configs 1-5's experiment files read through ``-co`` against their
    hand-copied flags, key by key; a copy of config 1's with one value
    changed must differ in that key alone."""
    flags = {"config1": CONFIG1_FLAGS, "config2": CONFIG2_FLAGS,
             "config3": CONFIG3_FLAGS, "config4": CONFIG4_FLAGS,
             "config5": CONFIG5_FLAGS}
    checked = {}
    for name, fname in EXPERIMENT_FILES.items():
        diff = configuration_diff(
            ["-co", os.path.join(EXPERIMENT_DIR, fname)], flags[name])
        if diff:
            raise AssertionError("{} read through -co differs from {}_FLAGS "
                                 "in {}".format(fname, name.upper(), diff))
        checked[name] = fname
    planted = os.path.join(workdir, "planted.yml")
    with open(os.path.join(EXPERIMENT_DIR, EXPERIMENT_FILES["config1"])) as f:
        text = f.read()
    with open(planted, "w") as f:
        f.write(text.replace("batch_size: 16", "batch_size: 32"))
    caught = configuration_diff(["-co", planted], CONFIG1_FLAGS)
    if caught != ["batch_size"]:
        raise AssertionError("a changed batch_size was read as {}".format(
            caught))
    return {"equal": checked, "planted_fault": "batch_size 16 -> 32",
            "planted_caught": caught}


def write_reference_pickle(path, cache, dataset_type, shift_row=None):
    """``cache``'s windows as the reference pickled a dataset: a
    ``deepards.dataset.ARDSRawDataset`` whose ``all_sequences`` hold
    [patient, data, target, hours] records (5 fields with metadata), made
    here with stand-in ``deepards`` modules.  ``shift_row``: that row's
    hours moved by one (a planted fault)."""
    import pickle

    top, sub = types.ModuleType("deepards"), types.ModuleType(
        "deepards.dataset")
    cls = type("ARDSRawDataset", (object,), {"__module__": "deepards.dataset"})
    sub.ARDSRawDataset = cls
    top.dataset = sub
    saved = {k: sys.modules.get(k) for k in ("deepards", "deepards.dataset")}
    sys.modules.update({"deepards": top, "deepards.dataset": sub})
    try:
        obj = cls()
        obj.all_sequences = []
        for i in range(len(cache.data)):
            hours = cache.hours[i].tolist()
            if i == shift_row:
                hours = [h + 1.0 for h in hours]
            record = [cache.patients[cache.patient_idx[i]], cache.data[i],
                      cache.target[i], hours]
            if cache.meta is not None:
                record.insert(2, cache.meta[i])
            obj.all_sequences.append(record)
        obj.dataset_type = dataset_type
        obj.total_kfolds = 5
        obj.kfold_num = 0
        obj.experiment_num = 1
        with open(path, "wb") as f:
            pickle.dump(obj, f, protocol=2)
    finally:
        for key, module in saved.items():
            if module is None:
                sys.modules.pop(key, None)
            else:
                sys.modules[key] = module
    return path


def cache_diff(got, want):
    """The fields of two window caches that differ (NaN equal to NaN)."""
    diff = [k for k in ("data", "target", "hours", "patient_idx")
            if not np.array_equal(getattr(got, k), getattr(want, k),
                                  equal_nan=True)]
    if got.patients != want.patients:
        diff.append("patients")
    if (got.meta is None) != (want.meta is None) or (
            got.meta is not None and not np.array_equal(got.meta, want.meta)):
        diff.append("meta")
    return diff


def reference_pickle_runs(root, device, breaths=800):
    """Config 1 (fold 0, 1 epoch) through the CLI on a seeded cohort,
    its dataset saved as ``.npz`` and rewritten as a reference pickle;
    the pickle's cache must equal the ``.npz``'s exactly (a planted hour
    shift must not), and ``--train-from-pickle`` of each must give the
    same losses exactly, with cuDNN's deterministic algorithms.  Returns
    (fields, the ``.npz`` path, the models dir)."""
    import torch

    from deepards_tpu_torch.cli.train import main as train_main
    from deepards_tpu_torch.data.dataset import ARDSRawDataset
    from deepards_tpu_torch.data.synthetic import generate_cohort

    def path(*parts):
        return os.path.join(root, *parts)

    cohort = generate_cohort(path("cohort"), n_patients=10,
                             n_breaths_per_patient=breaths, seed=SEED + 13)
    base = CONFIG1_FLAGS + ["--only-fold", "0", "--epochs", "1",
                            "--device", device]
    deterministic = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    runs, seconds = {}, {}
    try:
        for name, flags in (
                ("etl", ["--data-path", path("cohort"), "--cohort-file",
                         cohort, "--train-to-pickle", path("dataset.npz"),
                         "--save-model", "experiments.pt",
                         "--saved-models-dir", path("models")]),
                ("npz", ["--train-from-pickle", path("dataset.npz")]),
                ("reference", ["--train-from-pickle", path("reference.pkl")])):
            if name == "reference":
                saved = ARDSRawDataset.from_pickle(path("dataset.npz"))
                write_reference_pickle(path("reference.pkl"), saved.cache,
                                       saved.dataset_type)
                write_reference_pickle(path("shifted.pkl"), saved.cache,
                                       saved.dataset_type, PICKLE_SHIFTED_ROW)
            t0 = time.perf_counter()
            runs[name] = train_main(base + flags + [
                "--results-dir", path(name + "_results")])
            seconds[name] = time.perf_counter() - t0
    finally:
        torch.backends.cudnn.deterministic = deterministic
    diff = cache_diff(ARDSRawDataset.from_pickle(path("reference.pkl")).cache,
                      saved.cache)
    planted = cache_diff(ARDSRawDataset.from_pickle(path("shifted.pkl")).cache,
                         saved.cache)
    if diff or planted != ["hours"]:
        raise AssertionError("reference pickle vs .npz cache: {} differ; "
                             "the planted hour shift read as {}".format(
                                 diff, planted))
    losses = {}
    for name in ("npz", "reference"):
        meters = runs[name].results.reporting.meters
        losses[name] = [meters[k].values for k in ("loss_fold_0",
                                                   "test_loss_fold_0")]
    if not losses["npz"][0] or losses["npz"] != losses["reference"]:
        raise AssertionError("losses from the reference pickle {} differ "
                             "from the .npz run's {}".format(
                                 losses["reference"], losses["npz"]))
    return {"windows": len(saved.cache.data),
            "train_steps": len(losses["npz"][0]),
            "test_steps": len(losses["npz"][1]),
            "losses_equal": True, "cache_equal": True,
            "planted_fault": "row {} hours + 1".format(PICKLE_SHIFTED_ROW),
            "planted_caught": planted, "seconds": seconds}, \
        path("dataset.npz"), path("models")


def evaluate_layout(root, device, dataset, models_dir):
    """``cli.evaluate -co`` over a yml in ``evaluate_config``'s layout
    (its keys, ``models:`` of int keys holding lists) naming the run's
    fold-0 checkpoint twice: the two pseudo-epochs must be equal, and
    each patient's pred_frac within PREDICT_ATOL of the trainer's eval of
    the same checkpoint (``--load-checkpoint --no-train``)."""
    from deepards_tpu_torch.cli.evaluate import main as evaluate_main
    from deepards_tpu_torch.cli.train import main as train_main
    from deepards_tpu_torch.config import yamlfile

    layout = yamlfile.read(EVALUATE_LAYOUT)
    layout.update(train_from_pickle=dataset, device=device,
                  results_dir=os.path.join(root, "evaluate_results"),
                  models={0: ["experiments-fold0"] * 2})
    yml = os.path.join(root, "evaluate.yml")
    yamlfile.write(yml, layout)
    t0 = time.perf_counter()
    rows, aggregate, trainer = evaluate_main(
        ["-co", yml, "--saved-models-dir", models_dir])
    seconds = time.perf_counter() - t0
    records = trainer.results.results
    epochs = [{r["patient"]: r["pred_frac"] for r in records
               if r["epoch_num"] == e} for e in (0, 1)]
    evaluated = train_main(CONFIG1_FLAGS + [
        "--only-fold", "0", "--epochs", "1", "--device", device,
        "--train-from-pickle", dataset, "--load-checkpoint",
        os.path.join(models_dir, "experiments-fold0"), "--no-train",
        "--results-dir", os.path.join(root, "no_train_results")])
    want = {r["patient"]: r["pred_frac"] for r in evaluated.results.results}
    worst = max((abs(epochs[0][p] - want[p]) for p in want
                 if p in epochs[0]), default=float("inf"))
    if (epochs[0] != epochs[1] or sorted(epochs[0]) != sorted(want)
            or worst > PREDICT_ATOL or len(rows) != 1):
        raise AssertionError("evaluate -co: pseudo-epochs {}, the "
                             "trainer's eval {}".format(epochs, want))
    return {"patients": len(want), "pseudo_epochs": 2,
            "max_abs_pred_frac_vs_eval": worst, "atol": PREDICT_ATOL,
            "aggregate_rows": len(aggregate or ()), "seconds": seconds}


def sweep_subset(root, device, files=SWEEP_FILES):
    """``cli.registry_sweep --only files``: each config one debug epoch
    and an eval through ``cli.train``, each ok."""
    from deepards_tpu_torch.cli.registry_sweep import main as sweep_main

    out = os.path.join(root, "sweep.json")
    t0 = time.perf_counter()
    results = sweep_main(["--out", out, "--cohort", os.path.join(
        root, "regsweep", "cohort"), "--device", device,
        "--only"] + list(files))
    seconds = time.perf_counter() - t0
    failed = {n: results.get(n, {}).get("error", "not run")
              for n in files if not results.get(n, {}).get("ok")}
    if failed:
        raise AssertionError("registry sweep failed: {}".format(failed))
    return {"wall_s": {n: results[n]["wall_s"] for n in files},
            "backend": sorted({results[n]["backend"] for n in files}),
            "seconds": seconds}


def traced_steps(workdir, device):
    """``utils.profiling.trace`` around TRACED_STEPS graphed device-cache
    steps of config 1 (``StepTimer`` ticks after a synchronize); the
    Chrome trace must name a CUDA kernel on the card."""
    import torch

    from deepards_tpu_torch.train.loop import _epoch_order
    from deepards_tpu_torch.utils import profiling

    rng = np.random.default_rng(SEED + 17)
    conf = config_conf("config1")
    n = TRACED_STEPS * conf.batch_size
    ds = random_cache(rng, n, conf)
    trainer, runner = config_fold("config1", workdir, device, True, ds)
    ids, masks = _epoch_order(np.arange(n), conf.batch_size)
    trainer._device_steps(runner, ds, ids, masks, True)  # warm up, capture
    timer = profiling.StepTimer(warmup=0)
    timer.tick()
    with profiling.trace(os.path.join(workdir, "trace")) as path:
        for step in range(TRACED_STEPS):
            with profiling.annotate("step{}".format(step)):
                trainer._device_steps(runner, ds, ids[step:step + 1],
                                      masks[step:step + 1], True)
            if device == "cuda":
                torch.cuda.synchronize()
            timer.tick()
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    kernels = sorted({e["name"] for e in events if e.get("cat") == "kernel"})
    spans = [e["name"] for e in events if e.get("name", "").startswith(
        "step") and e.get("cat") == "user_annotation"]
    if device == "cuda" and not kernels:
        raise AssertionError("the trace names no CUDA kernel")
    if len(spans) < TRACED_STEPS:
        raise AssertionError("the trace holds {} step spans".format(
            len(spans)))
    report = timer.report(items_per_step=conf.batch_size)
    print("StepTimer.report(): " + json.dumps(report), flush=True)
    return {"kernel_names": len(kernels), "kernels_sample": kernels[:3],
            "step_spans": len(spans), "report": report,
            "trace_bytes": os.path.getsize(path)}


# the distributed phase: config 1 over 2 ranks of cli.launch_distributed
# (gloo, both on the one card) against one process at dp_devices 2
DIST_RANKS = 2
DIST_BATCH = 15  # the trained run's batch: odd, so the pad row is sharded
DIST_STEPS = 3  # the float32 steps whose params are held
DIST_TIMED_STEPS = 10
HERE = os.path.dirname(os.path.abspath(__file__))


def free_port():
    import socket

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def dist_env():
    """The ranks' environment: the checkout importable, one torch thread
    each, no TF32 in cuBLAS or cuDNN (``phase_env`` turns it off in this
    process), so that float32 is float32 on both sides, and each
    ``cli.train`` rank writing its DTW launches to its results dir."""
    from deepards_tpu_torch.cli.train import LAUNCH_COUNTS_ENV

    return dict(os.environ, PYTHONPATH=HERE + os.pathsep + os.environ.get(
        "PYTHONPATH", ""), OMP_NUM_THREADS="1", NVIDIA_TF32_OVERRIDE="0",
        **{LAUNCH_COUNTS_ENV: "1"})


def rank_launches(path):
    """The DTW launches a rank wrote to ``path`` when it ended; a rank
    that wrote none raises."""
    if not os.path.exists(path):
        raise AssertionError("{}: the rank wrote no launch count".format(
            path))
    with open(path) as f:
        return json.load(f)["dtw"]


def dist_saved(results_dir):
    """(meters, patient rows) of a run's results."""
    with np.load(glob.glob(os.path.join(results_dir,
                                        "meters_*.npz"))[0]) as z:
        meters = {k: z[k] for k in z.files}
    with open(glob.glob(os.path.join(results_dir,
                                     "*_patient_results.json"))[0]) as f:
        return meters, json.load(f)


def dist_runs(workdir, device, cohort):
    """Config 1's fold 0 (1 epoch, float32) four ways: an eval-only fold
    (``--no-train``, the fold's fixed init) and a trained fold at batch
    DIST_BATCH with a checkpoint after DIST_STEPS steps, each over
    DIST_RANKS ranks of ``cli.launch_distributed`` (started first, in the
    background) and in this process at ``--dp-devices 2`` meanwhile.
    Returns {run: (results dirs, models dir)}."""
    from deepards_tpu_torch.cli.train import main as train_main

    flags = CONFIG1_FLAGS + [
        "--data-path", cohort[0], "--cohort-file", cohort[1],
        "--only-fold", "0", "--epochs", "1", "--compute-dtype", "float32",
        "--device", device]
    extra = {"eval": ["--no-train"],
             "train": ["--batch-size", str(DIST_BATCH), "--save-model",
                       "dist.pt", "--checkpoint-every-n-steps",
                       str(DIST_STEPS), "--fused-steps", str(DIST_STEPS)]}
    procs, out = [], {}
    try:
        for run, more in extra.items():
            root = os.path.join(workdir, "distributed",
                                "{}_{}".format(run, DIST_RANKS))
            os.makedirs(root)
            log = open(os.path.join(root, "log.txt"), "w")
            procs.append((root, log, subprocess.Popen(
                [sys.executable, "-m",
                 "deepards_tpu_torch.cli.launch_distributed", "-n",
                 str(DIST_RANKS), "--results-dir",
                 os.path.join(root, "results"), "--"] + flags + more + [
                     "--saved-models-dir", os.path.join(root, "models")],
                cwd=HERE, env=dist_env(), stdout=log,
                stderr=subprocess.STDOUT)))
            out["{}_{}".format(run, DIST_RANKS)] = (
                [os.path.join(root, "results", "rank{}".format(r))
                 for r in range(DIST_RANKS)], os.path.join(root, "models"))
        for run, more in extra.items():
            root = os.path.join(workdir, "distributed", "{}_1".format(run))
            train_main(flags + more + [
                "--saved-models-dir", os.path.join(root, "models"),
                "--dp-devices", str(DIST_RANKS), "--results-dir",
                os.path.join(root, "results")])
            out["{}_1".format(run)] = ([os.path.join(root, "results")],
                                       os.path.join(root, "models"))
        failed = []
        for root, log, proc in procs:
            if proc.wait(timeout=600):
                failed.append(root)
            log.close()
        if failed:
            raise AssertionError("distributed runs failed: {}".format(
                {r: open(os.path.join(r, "log.txt")).read()[-1500:]
                 for r in failed}))
    finally:
        for _, log, proc in procs:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
            log.close()
    return out


def dist_steps(device, dtype, rows=slice(None)):
    """Config 1's 3 steps of ``CardVsCpu`` (its params, batches of 16 with
    a pad row, dropout off, training's clamp) on ``device`` in ``dtype``,
    over ``rows`` of each batch: {param: value after step 3} in
    float64."""
    _, params, _ = CardVsCpu("config1").run(device, dtype, rows=rows)
    return {k: v.numpy() for k, v in params[-1].items()}


def dist_timed_runner(workdir, device, graphs):
    """(trainer, runner) of config 1's step (its batch, bf16, dropout on)
    over a random batch already in the runner's buffers: this rank's
    rows of it in a run over processes."""
    import torch

    conf = config_conf("config1")
    ds = random_cache(np.random.default_rng(SEED + 3), conf.batch_size, conf)
    trainer, runner = config_fold("config1", workdir, device, graphs, ds)
    dev = trainer._get_device_cache(ds)
    ids = torch.arange(conf.batch_size, device=trainer.device)[
        trainer.axis.local(conf.batch_size)]
    for key, table in dev.items():
        torch.index_select(table, 0, ids, out=runner.inputs[key])
    runner.inputs["mask"].fill_(1.0)
    return trainer, runner


def distributed_worker(rank, port, result, workdir, device):
    """One of DIST_RANKS ranks: config 1's 3 float64 steps over its rows
    of each batch (``dist_steps`` within ``mesh.sharded_rows``), then, on
    the card, once ``result`` + ".go" exists (the card quiet), its eager
    sharded step timed.  Rank 0 writes the params to ``result`` (an
    ``.npz``) and the times beside it (``.json``); each rank its DTW
    launches (``.launches<rank>.json``)."""
    import torch

    import deepards_tpu_torch.ops.dtw as dtw_ops
    from deepards_tpu_torch.parallel import mesh

    dtw_ops.launches = 0
    torch.backends.cudnn.allow_tf32 = False  # as phase_env in the parent
    torch.backends.cuda.matmul.allow_tf32 = False
    mesh.initialize_distributed("127.0.0.1:{}".format(port), DIST_RANKS,
                                rank)
    axis = mesh.make_data_axis()
    with mesh.sharded_rows(axis):
        params = dist_steps(device, torch.float64, axis.local(BATCH))
    if rank == 0:
        np.savez(result, **params)
    times = {}
    if device == "cuda":
        _, runner = dist_timed_runner(workdir, device, False)
        while not os.path.exists(result + ".go"):
            time.sleep(0.1)
        times = {"train_step_ms": cuda_ms(runner.train, warmup=3,
                                          reps=DIST_TIMED_STEPS),
                 "eval_step_ms": cuda_ms(runner.eval, warmup=3,
                                         reps=DIST_TIMED_STEPS),
                 "rows_per_rank": runner.inputs["data"].shape[0]}
    if rank == 0:
        with open(result + ".json", "w") as f:
            json.dump(times, f)
    with open("{}.launches{}.json".format(result, rank), "w") as f:
        json.dump({"dtw": dtw_ops.launches}, f)


def distributed_checks(workdir, device, runs):
    """``distributed_worker`` on DIST_RANKS ranks, started before
    ``runs()`` (``dist_runs``, returned) and timing once it is done,
    against this process: config 1's 3 steps in float64, every element
    within TRAIN_STEP_ATOL's params (the float64 run that holds the first
    conv, as in config 1's card-vs-CPU check; the float32 run is
    ``dist_runs``' trained run); on the card the ranks' eager step beside
    this process's, eager and graphed, over the same batch.  Returns
    (runs' result, fields, failures); fields' ``dtw_launches``: each
    worker's."""
    import torch

    result = os.path.join(workdir, "distributed", "worker.npz")
    port = free_port()
    procs = [subprocess.Popen(
        [sys.executable, "-c", "import chip_smoke; chip_smoke."
         "distributed_worker({}, {}, {!r}, {!r}, {!r})".format(
             rank, port, result, workdir, device)], cwd=HERE,
        env=dist_env()) for rank in range(DIST_RANKS)]
    try:
        out = runs()
        one = dist_steps(device, torch.float64)
        open(result + ".go", "w").close()
        rcs = [p.wait(timeout=600) for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    if any(rcs):
        raise AssertionError("distributed workers failed: {}".format(rcs))
    fields, failed = {}, []
    fields["dtw_launches"] = [rank_launches("{}.launches{}.json".format(
        result, rank)) for rank in range(DIST_RANKS)]
    with np.load(result) as z:
        errs = {k: float(np.abs(z[k] - v).max()) for k, v in one.items()}
    over_limit = sorted(k for k, e in errs.items()
                        if e > TRAIN_STEP_ATOL["params"])
    fields["float64"] = {"params_max_abs_err": max(errs.values()),
                         "params_atol": TRAIN_STEP_ATOL["params"],
                         "over_atol": over_limit}
    if over_limit:
        failed.append("3 float64 steps: {} past {}".format(
            over_limit, TRAIN_STEP_ATOL["params"]))
    if device == "cuda":
        with open(result + ".json") as f:
            times = {"ranks_eager": json.load(f)}
        for mode, graphs in (("one_process_eager", False),
                             ("one_process_graphed", True)):
            _, runner = dist_timed_runner(workdir, device, graphs)
            times[mode] = {
                "train_step_ms": cuda_ms(runner.train, warmup=3,
                                         reps=DIST_TIMED_STEPS),
                "eval_step_ms": cuda_ms(runner.eval, warmup=3,
                                        reps=DIST_TIMED_STEPS)}
            del runner
        fields["step_times"] = dict(times, batch=BATCH,
                                    compute_dtype="bfloat16",
                                    steps_timed=DIST_TIMED_STEPS)
    return out, fields, failed


def dist_params_held(got, want):
    """Two checkpoints' float32 params held as config 1's card-vs-CPU
    check holds them (``TRAIN_STEP_ATOL``): every element within 1e-5 but
    those of ``BY_GRADIENT["config1"]`` (the first conv, whose gradient
    sums cancel: float32's summation order moves it by ~1e-2 of its
    largest element), which ``distributed_checks``' float64 run holds.
    Returns the errors and the tensors over."""
    errs = {k: float((got["params"][k] - want["params"][k]).abs().max())
            for k in want["params"]}
    held = {k: e for k, e in errs.items()
            if not k.startswith(BY_GRADIENT["config1"])}
    return {"params_max_abs_err": max(held.values()),
            "params_atol": TRAIN_STEP_ATOL["params"],
            "params_over": sorted(k for k, e in held.items()
                                  if e > TRAIN_STEP_ATOL["params"]),
            "not_held": {k: e for k, e in errs.items() if k not in held}}


def phase_distributed(workdir, device="cuda"):
    """Config 1 over DIST_RANKS ranks of ``cli.launch_distributed`` (gloo,
    both ranks on the one card, full width, float32, fold 0 x 1 epoch of
    the seeded cohort) against one process at ``--dp-devices 2``
    (``dist_runs``): every rank's meters and patient rows equal; the
    eval-only fold equal to the one process's (AUC exact, losses rtol
    1e-5); the trained run (batch DIST_BATCH, padded to 16 and sharded 8
    and 8) after DIST_STEPS steps: its params (rank 0's checkpoint) held
    to the one process's as config 1's check holds them
    (``dist_params_held``).  Around the runs ``distributed_checks``:
    config 1's 3 float64 steps over 2 ranks against one process, and on
    the card, after the runs, the ranks' eager step beside the one
    process's.  Every rank process runs no DTW: each writes its launches
    (from 0 at its start) when it ends, and the phase fails unless they
    sum to 0.  One JSON line.  Returns that sum, which the caller adds to
    this process's count for the path."""
    from deepards_tpu_torch.cli.train import LAUNCH_COUNTS_FILE
    from deepards_tpu_torch.train import checkpoint

    cohort = config_cohort(workdir, config_conf("config1"))
    t0 = time.perf_counter()
    runs, steps, failed = distributed_checks(
        workdir, device, lambda: dist_runs(workdir, device, cohort))
    fields = {"card": nvidia_smi_line() if device == "cuda" else None,
              "ranks": DIST_RANKS, "backend": "gloo",
              "flags": CONFIG1_FLAGS + ["--only-fold", "0", "--epochs", "1",
                                        "--compute-dtype", "float32"],
              "steps": steps, "runs_and_checks_seconds":
                  time.perf_counter() - t0}
    for run in ("eval", "train"):
        ranks = [dist_saved(d) for d in runs["{}_{}".format(
            run, DIST_RANKS)][0]]
        one = dist_saved(runs["{}_1".format(run)][0][0])
        meters, rows = ranks[0]
        for other_meters, other_rows in ranks[1:]:
            if other_rows != rows or any(
                    not np.array_equal(other_meters[k], meters[k])
                    for k in meters) or other_meters.keys() != meters.keys():
                failed.append("{}: the ranks' results differ".format(run))
        losses = {k: float(np.max(np.abs(meters[k] - one[0][k]) / np.maximum(
            np.abs(one[0][k]), 1e-12))) for k in meters if "loss" in k
            and meters[k].shape == one[0][k].shape}
        aucs = {k: (meters[k].tolist(), one[0][k].tolist())
                for k in meters if "auc" in k}
        fields[run] = {"loss_rel_err": losses, "auc": aucs,
                       "patients": len(rows),
                       "rows_equal": rows == one[1]}
        if run == "eval":
            if meters.keys() != one[0].keys() or any(
                    a != b for a, b in aucs.values()) or rows != one[1]:
                failed.append("eval-only: AUC or rows differ from one "
                              "process: {}".format(aucs))
            if any(e > 1e-5 for e in losses.values()):
                failed.append("eval-only: losses past rtol 1e-5: {}".format(
                    losses))
    name = "dist-epoch1-fold0-step{}".format(DIST_STEPS)
    got = checkpoint.restore(os.path.join(runs["train_2"][1], name))
    want = checkpoint.restore(os.path.join(runs["train_1"][1], name))
    held = dist_params_held(got, want)
    fields["train"].update(batch=DIST_BATCH, padded_to=16, steps=DIST_STEPS,
                           step=int(got["step"]), **held)
    if held["params_over"] or got["step"] != DIST_STEPS:
        failed.append("{} float32 steps against one process: {}, step "
                      "{}".format(DIST_STEPS, held, got["step"]))
    launches = {"{}_{}".format(run, DIST_RANKS): [
        rank_launches(os.path.join(d, LAUNCH_COUNTS_FILE))
        for d in runs["{}_{}".format(run, DIST_RANKS)][0]]
        for run in ("eval", "train")}
    launches["float64_workers"] = steps.pop("dtw_launches")
    ranks_sum = sum(sum(v) for v in launches.values())
    fields["rank_dtw_launches"] = dict(launches, total=ranks_sum)
    if ranks_sum:
        failed.append("the ranks launched the dtw kernel: {}".format(
            launches))
    fields["seconds"] = time.perf_counter() - t0
    emit("distributed", **fields)
    if failed:
        raise AssertionError("; ".join(failed))
    return ranks_sum


def phase_experiments(workdir, device="cuda", breaths=800,
                      sweep_files=SWEEP_FILES):
    """The experiment-file tools and the reference's pickles, with PyYAML
    and pandas blocked: configs 1-5's ymls through ``-co`` against their
    flags, ``cli.evaluate -co`` over the ``evaluate_config`` layout,
    ``cli.registry_sweep`` over ``sweep_files``, a reference pickle (of a
    10-patient cohort of ``breaths`` breaths each) trained through
    ``--train-from-pickle`` against its ``.npz``, and
    ``utils.profiling.trace`` around graphed steps."""
    root = os.path.join(workdir, "experiments")
    os.makedirs(root, exist_ok=True)
    with blocked_modules("yaml", "pandas"):
        fields = {"files": experiment_files_vs_flags(root)}
        pickled, dataset, models_dir = reference_pickle_runs(root, device,
                                                             breaths)
        fields["reference_pickle"] = pickled
        fields["evaluate"] = evaluate_layout(root, device, dataset,
                                             models_dir)
        fields["sweep"] = sweep_subset(root, device, sweep_files)
        fields["profiling"] = traced_steps(root, device)
    emit("experiments", **fields)


# the phases in the order of a whole run (``serve`` is the main path:
# the server, then DTW of its breaths), and the phases each reads the
# checkpoints or cohort of
PHASES = ("serve", "train", "graph_vs_eager", "config1_surface", "config2",
          "config3", "config4", "config4_unshuffled", "config7", "config5",
          "explain", "sequence", "two_d", "siamese", "backbones",
          "analytics", "experiments", "distributed", "dtw_similarity",
          "hetero")
PHASE_NEEDS = {"config1_surface": ("train",), "explain": ("train", "config5"),
               "analytics": ("train",)}


def cpu_jobs(phases):
    """The worker's jobs for ``phases``, in the order the card needs them:
    the card-vs-CPU CPU sides of configs 1-4 (``train``,
    ``config2``-``4``) and of the ``sequence``, ``siamese`` and
    ``backbones`` networks, each network's float64 pass and then its
    float32 pass, and last ``dtw_similarity``'s sub-cohort."""
    names = {"train": ["config1"], "config2": ["config2"],
             "config3": ["config3"], "config4": ["config4"],
             "sequence": list(SEQUENCE_FLAGS),
             "siamese": list(SIAMESE_FLAGS),
             "backbones": [n for n in BACKBONE_BY_BLOCK
                           if n != "protopnet_vgg11_bn"]}
    jobs = [(kind, n) for phase in PHASES if phase in phases
            for n in names.get(phase, ()) for kind in ("float64", "float32")]
    if "dtw_similarity" in phases:
        jobs.append(("similarity", None))
    return jobs


def parse_phases(argv=None):
    """The phases ``--phases a,b`` names, in a whole run's order (all of
    them without it); a phase whose needs are not named is refused."""
    import argparse

    parser = argparse.ArgumentParser(
        description="Smoke run of deepards_tpu_torch on one card.")
    parser.add_argument(
        "--phases", help="comma-separated phases to run after env, build "
        "and the kernel check (default: all): " + ", ".join(PHASES))
    args = parser.parse_args(argv)
    if not args.phases:
        return PHASES
    chosen = {p.strip() for p in args.phases.split(",") if p.strip()}
    unknown = sorted(chosen - set(PHASES))
    if unknown:
        parser.error("unknown phases: {}".format(", ".join(unknown)))
    for phase in sorted(chosen):
        missing = [p for p in PHASE_NEEDS.get(phase, ()) if p not in chosen]
        if missing:
            parser.error("{} reads the checkpoints of {}: add {} to "
                         "--phases".format(phase, ", ".join(
                             PHASE_NEEDS[phase]), ", ".join(missing)))
    return tuple(p for p in PHASES if p in chosen)


def main(argv=None):
    global CPU_SIDES
    phases = parse_phases(argv)
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False",
              file=sys.stderr)
        return 1
    from deepards_tpu_torch.ops.build import BUILD_DIR

    BUILD_DIR.mkdir(exist_ok=True)
    with tempfile.TemporaryDirectory(dir=BUILD_DIR) as sides_dir:
        # the CPU sides of card vs CPU start now, in a worker process of
        # half the cores, while the card runs the phases before them
        jobs = cpu_jobs(phases)
        threads = torch.get_num_threads()
        if jobs:
            # the cores split between the worker and this process, so
            # neither's threads wait on the other's
            cores = os.cpu_count() or 2
            CPU_SIDES = CpuSides(jobs, sides_dir, max(1, cores // 2))
            torch.set_num_threads(max(1, cores - cores // 2))
        try:
            return run_phases(phases)
        finally:
            if CPU_SIDES is not None:
                CPU_SIDES.close()
                CPU_SIDES = None
            torch.set_num_threads(threads)


def run_phases(phases):
    """Every phase of ``phases`` after env, build and the kernel check;
    the JSON lines, the card's line and the ok line."""
    import torch

    import deepards_tpu_torch.ops.dtw as dtw_ops
    import deepards_tpu_torch.ops.lstm as lstm_ops
    from deepards_tpu_torch.ops.build import BUILD_DIR

    # each phase's seconds on the host's clock, printed before the kernels
    seconds = {}
    began = time.perf_counter()
    # a phase that fails is recorded and the next phases run; the script
    # then fails before its result lines
    failures = {}

    def timed(phase, fn, *args, **kwargs):
        t0 = time.perf_counter()
        try:
            return fn(*args, **kwargs)
        except Exception as e:  # noqa: BLE001 - recorded, raised at the end
            if phase in ("env", "build", "kernel", "lstm"):
                raise
            import traceback

            traceback.print_exc()
            failures[phase] = "{}: {}".format(type(e).__name__, e)[:2000]
            return None
        finally:
            seconds[phase] = (seconds.get(phase, 0.0)
                              + time.perf_counter() - t0)

    def counted(phase, fn, *args, **kwargs):
        """A path's DTW launches: the count from 0 just before it, read
        just after (its LSTM launches into LSTM_LAUNCHES)."""
        dtw_ops.launches = 0
        lstm_before = lstm_ops.launches
        timed(phase, fn, *args, **kwargs)
        LSTM_LAUNCHES[phase] = (LSTM_LAUNCHES.get(phase, 0)
                                + lstm_ops.launches - lstm_before)
        return dtw_ops.launches

    smi = timed("env", phase_env)
    timed("build", phase_build)
    dtw_stats = timed("kernel", phase_kernel)
    lstm_stats = timed("lstm", phase_lstm)

    # the main path
    by_path = {}
    if "serve" in phases:
        dtw_ops.launches = 0
        with tempfile.TemporaryDirectory(dir=BUILD_DIR) as work:
            windows = timed("serve", phase_serve, work)
        timed("dtw_served", phase_dtw_served, windows)
        by_path["serve"] = dtw_ops.launches
        if by_path["serve"] == 0:
            failures.setdefault("serve", "the main path never launched the "
                                "dtw kernel")

    # the training paths run no hand-written kernel: each one's count
    # required to stay 0
    with tempfile.TemporaryDirectory(dir=BUILD_DIR) as work:
        for phase, fn in (
                ("train", lambda: phase_train(work, smi)),
                ("graph_vs_eager", lambda: phase_graph_vs_eager(work)),
                ("config1_surface", lambda: phase_config1_surface(work))):
            if phase in phases:
                by_path["config1"] = by_path.get("config1", 0) + counted(
                    phase, fn)
        for name in ("config2", "config3", "config4"):
            if name in phases:
                by_path[name] = counted(name, phase_config, work, name)
        for name, phase in (("config4_unshuffled", phase_config4_unshuffled),
                            ("config7", phase_config7),
                            ("config5", phase_config5)):
            if name in phases:
                by_path[name] = counted(name, phase, work)
        if "explain" in phases:
            # over config 1's and config 5's fold-0 checkpoints: the count
            # from 0 just before dtw_clust (inside the phase)
            by_path["explain"] = timed(
                "explain", phase_explain, work,
                cam_checkpoint=os.path.join(work, "config1_models",
                                            "config1-fold0"),
                ppnet_checkpoint=os.path.join(work, "config5_models",
                                              "config5-fold0"),
                per_cell=dtw_stats["fp32_per_cell"]) or 0
            if not by_path["explain"]:
                failures.setdefault("explain", "the explain path never "
                                    "launched the dtw kernel")
        # a line a network: each one's count from 0 just before it
        # (inside the phase), read just after
        for phase, fn in (("sequence", phase_sequence),
                          ("two_d", phase_two_d),
                          ("siamese", phase_siamese),
                          ("backbones", phase_backbones)):
            if phase in phases:
                by_path.update(timed(phase, fn, work) or {})
        if "analytics" in phases:
            # the DTW paths' counts from 0 just before each (inside the
            # phase), read just after
            by_path.update(timed(
                "analytics", phase_analytics, work,
                per_cell=dtw_stats["fp32_per_cell"],
                eval_models=os.path.join(work, "config1_models")) or {})
        if "experiments" in phases:
            by_path["experiments"] = counted("experiments", phase_experiments,
                                             work)
        if "distributed" in phases:
            # this process's count (its dp_devices 2 runs), from 0 just
            # before the phase, and the sum of its rank processes' own
            dtw_ops.launches = 0
            ranks = timed("distributed", phase_distributed, work)
            by_path["distributed"] = dtw_ops.launches + (ranks or 0)
    training = {name: n for name, n in by_path.items()
                if name in CONFIG_FLAGS
                or name in ("experiments", "distributed")}
    emit("train_path_kernel_launches", dtw=training)
    if any(training.values()):
        failures["training_paths"] = "a training path launched the dtw " \
            "kernel: {}".format(training)
    no_lstm = [p for p in LSTM_PATHS if LSTM_LAUNCHES.get(p) == 0]
    emit("lstm_kernel_launches", by_path=LSTM_LAUNCHES)
    if no_lstm:
        failures["lstm_paths"] = "LSTM networks that never launched the " \
            "LSTM kernels: {}".format(no_lstm)

    # the DTW heterogeneity paths: the sweep's counts from 0 just before
    # it (inside the phase, whose checks launch the kernel too), the CLI
    # chain's just before it, each read just after
    with tempfile.TemporaryDirectory(dir=BUILD_DIR) as work:
        if "dtw_similarity" in phases:
            by_path["dtw_similarity"] = timed(
                "dtw_similarity", phase_dtw_similarity, work,
                per_cell=dtw_stats["fp32_per_cell"]["strip"]) or 0
        if "hetero" in phases:
            dtw_ops.launches = 0
            by_path["hetero"] = timed("hetero", phase_hetero, work) or 0
            if dtw_ops.launches != by_path["hetero"]:
                failures.setdefault("hetero", "hetero launches: {} counted, "
                                    "{} by step".format(dtw_ops.launches,
                                                        by_path["hetero"]))
    if CPU_SIDES is not None:
        emit("cpu_worker", **CPU_SIDES.report())
    emit("phase_seconds", total=time.perf_counter() - began,
         phases=list(phases), **seconds)
    if failures:
        emit("failed_phases", **failures)
        raise AssertionError("phases failed: {}".format(
            ", ".join(failures)))

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
    }, {
        "name": "lstm",
        "route": "cuda",
        "source": "deepards_tpu_torch/ops/csrc/lstm.cu",
        "replaces": None,
        "launches": lstm_ops.launches,
        "launches_by_path": LSTM_LAUNCHES,
        "max_gap": max(c["max_gap"] for c in lstm_stats["checks"].values()),
        "ms": lstm_stats["ms"],
        "device_ms": lstm_stats["device_ms"],
        "plain_ms": lstm_stats["plain_ms"],
        "floor_ms": lstm_stats["floor_ms"],
        "bound_by": "latency: 2 x 2,048 cluster barriers",
        "library_ms": lstm_stats["library_ms"],
    }]}), flush=True)
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
