#!/usr/bin/env python3
"""Where a network's float32 parts from float64 on the card.

    python3 float32_gap.py [--device cuda|cpu] [--network NAME]
                           [--full-depth] [--control THREADS]

``chip_smoke.py`` holds cnn_to_nested_transformer's float32 params, card
against CPU, after the first of its 3 full-width train steps only
(``FLOAT32_PARAM_STEPS``): after steps 2 and 3 the card's float32 parts
from float64 5-10x further than the CPU's.  This script reads why, with
the smoke's own harness, and prints one JSON line each:

- ``op_errors``: each module run alone on the inputs it gets in the
  float64 forward, in float32 on the CPU and on the card, each side's
  distance from float64, forward and backward, and the modules with the
  largest card-over-CPU ratios;
- ``settings``: the 3 steps with the params held after each, under each
  cuDNN setting the port controls.

With ``--network`` another network of the smoke (a senet at the depth
the smoke holds it, or with ``--full-depth`` at its own) prints one
``clamp_swings`` line instead:
the smoke's 3 card-vs-CPU steps with its float32 params held after all 3,
and for each step each side's float32 gradients after the clamp
(``--clip-val``) against float64's on the CPU.

With ``--control THREADS`` (a comma-separated list) it prints one
``cpu_control`` line a thread count instead: the smoke's CPU float32
control of ``--network`` (its batch's rows permuted against the run in
order, 3 steps) with float64's clamp decisions replayed and with each
run's own (``cpu_control``), on the CPU alone.

It runs on the card (TF32 off, as the smoke sets it) unless ``--device
cpu``, where both sides are the CPU; it gates nothing and exits non-zero
only when there is no card or the harness's own controls fail.  About 30 s
on an H100 (the nested transformer).
"""
import argparse
import copy
import json
import sys

import numpy as np
import torch

import chip_smoke as smoke
from chip_smoke import C, L

NETWORK = "cnn_to_nested_transformer"


def op_errors(device, name=NETWORK, top=6):
    """Each module of network ``name`` at full width, run alone on the
    inputs it gets in the float64 forward of the smoke's card-vs-CPU
    first step (one patient of NESTED_REAL windows in bucket
    NESTED_BUCKET, dropout off): forward, and backward from a seeded
    gradient of its output, in float64 on the CPU and in float32 on the
    CPU and on the card.  A side's forward error is the largest distance
    of its output from float64's over the largest float64 element; its
    backward error the same over each input and param gradient (the
    largest), leaving out a gradient that is zero in exact arithmetic
    (float64's under 1e-9 of the module's largest: attention's key
    bias).  Returns, per module,
    both sides' errors and the card's over the CPU's, and the ``top``
    leaf modules by each ratio."""
    from deepards_tpu_torch.train.loop import Trainer

    conf = smoke.config_conf(name, "--device", "cpu")
    s = conf.n_sub_batches
    trainer = Trainer(conf, verbose=False)
    trainer.n_sub_batches = s
    model = trainer.build_model().reset_parameters(
        torch.Generator().manual_seed(smoke.SEED)).double()
    rng = np.random.default_rng(smoke.SEED + 2)
    raw = np.zeros((smoke.NESTED_BUCKET, s, C, L), np.float64)
    real = smoke.make_windows(rng, smoke.NESTED_REAL, s)
    raw[:smoke.NESTED_REAL] = (real - real.mean()) / real.std()
    window_mask = (torch.arange(smoke.NESTED_BUCKET)[None]
                   < smoke.NESTED_REAL)
    calls = []

    def record(module_name):
        def hook(module, args, kwargs, out):
            calls.append((module_name, module, args, kwargs))
        return hook

    handles = [m.register_forward_hook(record(n), with_kwargs=True)
               for n, m in model.named_modules() if n]
    with torch.no_grad():
        model(torch.from_numpy(raw)[None], True, None,
              window_mask=window_mask)
    for h in handles:
        h.remove()

    def local(module, args, kwargs, dev, dtype, seed):
        mod = copy.deepcopy(module).to(device=dev, dtype=dtype)
        leaves = []

        def place(a):
            if not torch.is_tensor(a):
                return a
            if not a.is_floating_point():
                return a.to(dev)
            a = a.detach().to(device=dev, dtype=dtype).requires_grad_(True)
            leaves.append(a)
            return a

        out = mod(*[place(a) for a in args],
                  **{k: place(v) for k, v in kwargs.items()})
        out = out[0] if isinstance(out, tuple) else out
        grad_out = torch.randn(out.shape, dtype=torch.float64,
                               generator=torch.Generator().manual_seed(seed))
        grads = torch.autograd.grad(
            out, leaves + list(mod.parameters()),
            grad_out.to(device=dev, dtype=dtype), allow_unused=True)
        return [t.detach().to("cpu", torch.float64)
                for t in [out] + [g for g in grads if g is not None]]

    rows = {}
    for k, (module_name, module, args, kwargs) in enumerate(calls):
        if module_name in rows:  # a module called twice: its first call
            continue
        ref = local(module, args, kwargs, "cpu", torch.float64, k)
        scale = [float(r.abs().max()) for r in ref]
        kept = [i for i in range(1, len(ref))
                if scale[i] > 1e-9 * max(scale[1:])]
        row = {"leaf": not any(True for _ in module.children())}
        for side, dev in (("cpu", "cpu"), ("device", device)):
            got = local(module, args, kwargs, dev, torch.float32, k)
            errs = [float((g - r).abs().max()) / max(scale[i], 1e-300)
                    for i, (g, r) in enumerate(zip(got, ref))]
            row[side] = {"forward": errs[0], "backward": max(
                [errs[i] for i in kept], default=0.0)}
        for part in ("forward", "backward"):
            row[part + "_ratio"] = row["device"][part] / max(
                row["cpu"][part], 1e-300)
        rows[module_name] = row
    leaves = [n for n, r in rows.items() if r["leaf"]]
    return {"modules": rows, **{
        "top_by_{}_ratio".format(part): [
            {"module": n, **rows[n]} for n in sorted(
                leaves, key=lambda n: -rows[n][part + "_ratio"])[:top]]
        for part in ("forward", "backward")}}


SETTINGS = (("cudnn_default", (False, True)),
            ("cudnn_deterministic", (True, True)),
            ("cudnn_off", (False, False)))


def settings(device, name=NETWORK):
    """The smoke's card-vs-CPU steps of ``name`` with its float32 params
    held after all 3 steps, under each cuDNN setting the port controls:
    as it trains, cuDNN's deterministic algorithms, and cuDNN off
    (PyTorch's own convolution kernels).  Per setting, the card's and the
    CPU's float32 distance from float64 after each step, the elements
    over the limit, and the check's failure (None where it passes).  A
    failure of the harness's own controls (a planted fault passed, the
    CPU failing against itself) raises."""
    # the held steps are what this reads: all 3 in this process
    smoke.FLOAT32_PARAM_STEPS.pop(name, None)
    out = {}
    for setting, (deterministic, enabled) in SETTINGS:
        torch.backends.cudnn.deterministic = deterministic
        torch.backends.cudnn.enabled = enabled
        fields = {"atol": smoke.TRAIN_STEP_ATOL, "by_gradient": {}}
        try:
            smoke._train_card_vs_cpu(device, name, fields)
            failure = None
        except AssertionError as exc:
            failure = str(exc)
            if not failure.startswith(name + " card vs CPU after 3 steps"):
                raise
        f32 = fields["float32"]
        out[setting] = {
            "failure": failure,
            **{"{}_vs_float64".format(side): [
                r["max_abs"] for r in f32["{}_vs_float64".format(side)]]
               for side in ("device", "cpu")},
            "over_atol_held_by_step": [
                f32["after_step_{}".format(k)]["over_atol_held"]
                for k in (1, 2, 3)]}
    return out


def clamp_swings(device, name, top=3):
    """The smoke's card-vs-CPU steps of ``name`` with its
    float32 params held after all 3 steps: the check's failure (None where
    it passes), each side's float32 distance from float64 after each step,
    and per step each side's float32 gradients, clamped as the optimizer
    clamps them, against float64's on the CPU: the elements apart by more
    than 1e-3 and the ``top`` largest differences with their tensor and
    both values.  A failure of the harness's own controls is the
    failure too (the CPU against itself with the rows permuted, which
    comes after the float32 readings)."""
    from deepards_tpu_torch.train import steps
    from deepards_tpu_torch.train.loop import Trainer

    smoke.FLOAT32_PARAM_STEPS.pop(name, None)
    conf = smoke.config_conf(name, "--device", "cpu")
    trainer = Trainer(conf, verbose=False)
    trainer.n_sub_batches = conf.n_sub_batches
    names = [n for n, _ in trainer.build_model().named_parameters()]
    clip = conf.clip_val if conf.get("clip_grad") else float("inf")
    # every optimizer step's gradients before the clamp, in the order the
    # check runs them, 3 steps each: float64 on the CPU, float64 and
    # float32 on the card, the card's planted clamp flip (a clipped
    # optimizer's, but of OWN_CLAMPS), float32 on the CPU, then its own
    # controls
    grads = []
    step = steps.ClippedOptimizer.step

    def logged(self):
        grads.append([p.grad.detach().to("cpu", torch.float64, copy=True)
                      .clamp(-clip, clip) for p in self.params])
        return step(self)

    steps.ClippedOptimizer.step = logged
    fields = {"atol": smoke.TRAIN_STEP_ATOL, "by_gradient": {}}
    try:
        smoke._train_card_vs_cpu(device, name, fields)
        failure = None
    except AssertionError as exc:
        failure = str(exc)
    finally:
        steps.ClippedOptimizer.step = step
    exact = grads[0:3]
    # the planted flip's run: a clipped network that replays its clamps
    cpu = 12 if conf.get("clip_grad") and name not in smoke.OWN_CLAMPS \
        else 9
    swings = []
    for k in range(3):
        row = {}
        for side, run in (("cpu", grads[cpu:cpu + 3]),
                          ("device", grads[6:9])):
            diffs = [((got - want).abs(), n, got, want)
                     for n, got, want in zip(names, run[k], exact[k])]
            largest = sorted(((float(d.max()), n, int(d.argmax()), g, w)
                              for d, n, g, w in diffs), reverse=True)[:top]
            row[side] = {
                "over_1e-3": sum(int((d > 1e-3).sum()) for d, *_ in diffs),
                "largest": [{"tensor": n, "diff": d,
                             "float32": float(g.flatten()[i]),
                             "float64": float(w.flatten()[i])}
                            for d, n, i, g, w in largest]}
        swings.append(row)
    f32 = fields["float32"]
    return {"batch": fields["batch"], "failure": failure,
            **{"{}_vs_float64".format(side): [
                r["max_abs"] for r in f32["{}_vs_float64".format(side)]]
               for side in ("device", "cpu")},
            "over_atol_held_by_step": [
                f32["after_step_{}".format(k)]["over_atol_held"]
                for k in (1, 2, 3)],
            "clamp_swings": swings}


def cpu_control(name, threads):
    """The CPU float32 control of the smoke's card-vs-CPU check of
    network ``name`` on ``threads`` torch threads: the run over the
    batch's rows permuted against the run in order, with the float64
    run's clamp decisions replayed (``replayed``, as the smoke runs every
    network but those of ``OWN_CLAMPS``) and with each run's own
    (``own``), each step's largest distance and held elements over the
    limit; and by clamp call, the elements where float32's own decision
    differs from float64's, and float64's clamped elements."""
    torch.set_num_threads(threads)
    c = smoke.CardVsCpu(name)
    # recorded and replayed here whether or not the smoke replays them
    c.replays_clamps = c.clip
    f64 = []
    _, _, sorts = c.run("cpu", torch.float64, clamps=f64)
    own = []
    remap = smoke.remapped(c.permuted, c.nested)
    out = {"threads": threads}
    for variant, kwargs, records in (
            ("own", {}, own), ("replayed", {"clamp_replay": f64}, None)):
        steps = c.run("cpu", torch.float32, replay=sorts, clamps=records,
                      **kwargs)[1]
        permuted = c.run("cpu", torch.float32, rows=c.permuted,
                         replay=sorts, remap=remap, **kwargs)[1]
        out[variant] = [{"max_abs": r["max_abs"],
                         "over_atol_held": r["over_atol_held"]}
                        for r in c.compare(permuted, steps, c.held(True))]
    out["float32_decisions_apart_by_call"] = [
        sum(int((a[n] != b[n]).sum()) for n in a) for a, b in zip(own, f64)]
    out["float64_clamped_by_call"] = [
        sum(int(m.sum()) for m in r.values()) for r in f64]
    return out


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[1])
    parser.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    parser.add_argument("--network", default=NETWORK,
                        help="a network of chip_smoke.CONFIG_FLAGS")
    parser.add_argument("--full-depth", action="store_true",
                        help="a senet at its own depth")
    parser.add_argument("--control", help="thread counts, comma-separated:"
                        " the CPU's float32 control with and without the "
                        "clamp replay")
    args = parser.parse_args(argv)
    if args.device == "cuda":
        if not torch.cuda.is_available():
            print("float32_gap: torch.cuda.is_available() is False",
                  file=sys.stderr)
            return 1
        smoke.phase_env()  # TF32 off; prints the card's name and limit
    if args.network == NETWORK:
        smoke.emit("op_errors", network=NETWORK, **op_errors(args.device))
        smoke.emit("settings", network=NETWORK, **settings(args.device))
        return 0
    name = args.network
    if args.full_depth:
        smoke.NEW_DEPTH["one_block_a_stage"]["card_vs_cpu"] = ()
    with smoke.one_block_a_stage(name, "card_vs_cpu") as blocks:
        if args.control:
            for threads in args.control.split(","):
                smoke.emit("cpu_control", network=name,
                           blocks_a_stage=blocks,
                           **cpu_control(name, int(threads)))
            return 0
        smoke.emit("clamp_swings", network=name, blocks_a_stage=blocks,
                   **clamp_swings(args.device, name))
    return 0


if __name__ == "__main__":
    sys.exit(main())
