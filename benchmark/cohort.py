"""The traffic generator: a cohort of ventilated patients from a seed.

A traffic file (``traffic/<name>.json``) gives the cohort's parameters:

- ``patients``: how many; patient k (0-based) is ARDS when k is odd, so
  the classes alternate;
- ``windows``: [least, most] windows a patient holds, spread evenly over
  the patients in order (24 h at about a window a minute, less the
  frames a ventilator drops), the same for every seed;
- ``fold``: the fold of ``kfolds`` the run trains or tests;
- ``epoch``: ``train`` (the fold's train split) or ``test`` (its test
  split, forward only).

The seed draws the values alone: each breath of each window is a
half-sine inspiration and an exponential expiration of random period,
amplitude and phase, with noise, drawn on the device.  Window k of a
patient starts k * S breaths of 3 s into the study.
"""
import numpy as np
import torch

BREATH_SECONDS = 3.0
WINDOW = 224  # samples a breath holds
CHUNK = 8192  # windows drawn at a time: the transient memory of a draw


def window_counts(traffic):
    low, high = traffic["windows"]
    return np.rint(np.linspace(low, high, traffic["patients"])).astype(
        np.int64)


def classes(traffic):
    """Each patient's class, 1 for ARDS."""
    return np.arange(traffic["patients"]) % 2


def patient_ids(traffic):
    return [str(k + 1) for k in range(traffic["patients"])]


def rows(traffic):
    """(patient id of each row, class of each row, row range of each
    patient)."""
    counts = window_counts(traffic)
    ids = np.repeat(np.asarray(patient_ids(traffic)), counts)
    ys = np.repeat(classes(traffic), counts)
    ends = np.cumsum(counts)
    return ids, ys, [(int(e - c), int(e)) for c, e in zip(counts, ends)]


def make_windows(n, shape, seed, device):
    """(n,) + ``shape`` (S, C, L) float32 flow windows drawn on
    ``device``, returned on the host."""
    s, c, length = shape
    gen = torch.Generator(device=device).manual_seed(int(seed))
    t = torch.arange(length, device=device, dtype=torch.float32) * 0.02
    out = np.empty((n,) + tuple(shape), np.float32)
    for start in range(0, n, CHUNK):
        m = min(CHUNK, n - start)
        breath = (m, s, c, 1)
        period = 2.5 + 1.5 * torch.rand(breath, generator=gen, device=device)
        amp = 30.0 + 30.0 * torch.rand(breath, generator=gen, device=device)
        phase = (t / period + torch.rand(breath, generator=gen,
                                         device=device)) % 1.0
        flow = torch.where(
            phase < 0.35, amp * torch.sin(torch.pi * phase / 0.35),
            -0.8 * amp * torch.exp(-8.0 * (phase - 0.35)))
        flow += torch.randn((m, s, c, length), generator=gen, device=device)
        out[start:start + m] = flow.cpu().numpy()
    return out


def hours(traffic, s):
    """(N, S) hour into the study of each breath window."""
    counts = window_counts(traffic)
    per = [np.arange(k * s, dtype=np.float32).reshape(k, s)
           for k in counts]
    return np.concatenate(per) * np.float32(BREATH_SECONDS / 3600.0)
