"""Time the CUDA DTW kernel at chosen shapes, side by side in one process.

    python -m deepards_tpu_torch.ops.dtw_timing 132x4480 256x4480:2240

Each shape is ``BxN`` (every pair at full length N) or ``BxN:LO`` (lengths
drawn in [LO, N], as in ``chip_smoke.py``).  The shapes are timed in turn,
twice each (forward, then backward): ``ms`` by CUDA events around ``reps``
back-to-back launches (the wrapper's host time hides behind kernels longer
than it), ``device_ms`` by torch.profiler, the kernel alone.  Prints one
JSON line per timing, with the card's name.
"""
import argparse
import json

import numpy as np
import torch

from deepards_tpu_torch.ops.dtw import dtw_cuda


def make_pairs(rng, bsz, n, lo, hi):
    """(B, n) zero-padded pairs with lengths drawn in [lo, hi]."""
    a = rng.normal(size=(bsz, n)).astype(np.float32)
    b = rng.normal(size=(bsz, n)).astype(np.float32)
    la = rng.integers(lo, hi + 1, size=bsz).astype(np.int32)
    lb = rng.integers(lo, hi + 1, size=bsz).astype(np.int32)
    a[np.arange(n)[None, :] >= la[:, None]] = 0
    b[np.arange(n)[None, :] >= lb[:, None]] = 0
    return a, b, la, lb


def kernel_ms(args, reps):
    """Milliseconds per launch over ``reps`` back-to-back launches."""
    dtw_cuda(*args)
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        dtw_cuda(*args)
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


# profiles device_ms takes before it gives up
PROFILE_ATTEMPTS = 3


def device_ms(fn, reps=10):
    """Mean device time of the dtw kernel launches that torch.profiler
    records over ``reps`` calls of ``fn``.  It may record fewer launches
    than were made, so the mean is over those it recorded; a profile that
    records none (seen once on an H100) is taken again, up to
    PROFILE_ATTEMPTS profiles."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    for _ in range(PROFILE_ATTEMPTS):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
        kernels = [e for e in prof.key_averages()
                   if e.device_type == DeviceType.CUDA and "dtw" in e.key]
        count = sum(e.count for e in kernels)
        if count:
            return sum(e.self_device_time_total
                       for e in kernels) / count / 1e3
    raise RuntimeError("the profiler recorded no dtw kernel in {} "
                       "profiles".format(PROFILE_ATTEMPTS))


def parse_shape(text):
    size, _, lo = text.partition(":")
    bsz, n = (int(x) for x in size.split("x"))
    return bsz, n, int(lo) if lo else n


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("shapes", nargs="+", type=parse_shape)
    parser.add_argument("--reps", type=int, default=20)
    parser.add_argument("--seed", type=int, default=0)
    args = parser.parse_args(argv)
    rng = np.random.default_rng(args.seed)
    dev = torch.device("cuda")
    inputs = [[torch.from_numpy(x).to(dev)
               for x in make_pairs(rng, bsz, n, lo, n)]
              for bsz, n, lo in args.shapes]
    order = list(range(len(inputs)))
    for turn, index in enumerate(order + order[::-1]):
        bsz, n, lo = args.shapes[index]
        print(json.dumps({
            "device": torch.cuda.get_device_name(0), "turn": turn, "B": bsz,
            "n": n, "lengths": [lo, n],
            "ms": kernel_ms(inputs[index], args.reps),
            "device_ms": device_ms(lambda: dtw_cuda(*inputs[index]))}),
            flush=True)


if __name__ == "__main__":
    main()
