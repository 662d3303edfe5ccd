"""Window-warping data augmentations (Le Guennec 2016 family).

A copy of ``deepards_tpu/data/augment.py``: numpy and scipy only, kept in
the port so that it imports nothing of the JAX package.  Naive window
warping and inspiratory/expiratory-limb warping driven by x0 detection
(reference: deepards/augmentation.py:8-165) are host-side transforms of
raw (pre-normalization) windows; the device pipeline then forces mu = 0
while transforms are active (reference: deepards/dataset.py:1371-1373).
Every draw comes from the ``rng`` passed in, in the JAX package's order,
so the same seed warps the same windows bit for bit.
"""
import math

import numpy as np
from scipy.signal import resample

from deepards_tpu_torch.data.breath import find_x0_index


class Compose:
    def __init__(self, transforms):
        self.transforms = transforms

    def __call__(self, sub_batch, rng=None):
        for t in self.transforms:
            sub_batch = t(sub_batch, rng)
        return sub_batch


class NaiveWindowWarping:
    """(reference: augmentation.py:8-49)"""

    def __init__(self, rate_lower_bound, rate_upper_bound, probability):
        if not 0 <= probability <= 1:
            raise ValueError(
                "Probability bounding needs to be between 0 and 1."
            )
        self.rate_lower_bound = rate_lower_bound
        self.rate_upper_bound = rate_upper_bound
        self.probability = probability
        self.min_size = 10
        self.max_size = int(224 / 2 / rate_upper_bound)

    def __call__(self, sub_batch, rng=None):
        rng = rng or np.random.default_rng()
        if rng.random() > self.probability:
            return sub_batch
        sub_batch = np.array(sub_batch, copy=True)
        n, chans, seq_len = sub_batch.shape
        for b in range(n):
            ratio = rng.uniform(self.rate_lower_bound, self.rate_upper_bound)
            slice_len = int(rng.integers(self.min_size, self.max_size + 1))
            start = int(rng.integers(0, seq_len - slice_len))
            end = start + slice_len
            chunk = sub_batch[b, 0, start:end]
            new_size = int(math.floor(slice_len * ratio))
            new_chunk = resample(chunk, max(new_size, 2))
            new_inst = np.concatenate(
                [sub_batch[b, 0, :start], new_chunk, sub_batch[b, 0, end:]]
            )
            if len(new_inst) >= seq_len:
                sub_batch[b, 0] = new_inst[:seq_len]
            else:
                sub_batch[b, 0] = resample(new_inst, seq_len)
        return sub_batch


class IEWindowWarpingBase:
    """(reference: augmentation.py:52-127)"""

    def __init__(self, rate_lower_bound, rate_upper_bound, probability):
        if not 0 <= probability <= 1:
            raise ValueError(
                "Probability bounding needs to be between 0 and 1."
            )
        self.rate_lower_bound = rate_lower_bound
        self.rate_upper_bound = rate_upper_bound
        self.probability = probability

    def warp(self, sub_batch, i_or_e_choices, rng=None):
        rng = rng or np.random.default_rng()
        if rng.random() > self.probability:
            return sub_batch
        sub_batch = np.array(sub_batch, copy=True)
        n, chans, seq_len = sub_batch.shape
        for b in range(n):
            inst = sub_batch[b, 0]
            x0_idx = find_x0_index(inst)
            ratio = rng.uniform(self.rate_lower_bound, self.rate_upper_bound)
            use_i = bool(i_or_e_choices[b])

            if x0_idx >= seq_len - 1:
                # no expiration present: stretch the whole window
                ratio = rng.uniform(1.0, self.rate_upper_bound)
                n_new = int(math.floor(seq_len * ratio))
                new_inst = resample(inst, max(n_new, 2))[:seq_len]
                if len(new_inst) < seq_len:
                    new_inst = resample(new_inst, seq_len)
            elif use_i:
                end = max(x0_idx, 2)
                n_new = int(math.floor(end * ratio))
                if n_new <= 1:
                    n_new = end
                new_chunk = resample(inst[:end], n_new)
                n_rem = seq_len - n_new
                if n_rem <= 0:
                    new_inst = new_chunk[:seq_len]
                elif n_rem == 1:
                    new_inst = np.append(new_chunk, inst[end:])[:seq_len]
                else:
                    new_inst = np.append(
                        new_chunk, resample(inst[end:], n_rem)
                    )
            else:
                start = min(x0_idx, seq_len - 2)
                n_new = int(math.floor((seq_len - start) * ratio))
                if n_new <= 1:
                    n_new = seq_len - start
                new_chunk = resample(inst[start:], n_new)
                n_rem = seq_len - n_new
                if n_rem <= 0:
                    new_inst = np.append(inst[:start], new_chunk)[:seq_len]
                elif n_rem == 1:
                    new_inst = np.append(inst[:start], new_chunk)[:seq_len]
                else:
                    new_inst = np.append(
                        resample(inst[:start], n_rem), new_chunk
                    )
            if len(new_inst) != seq_len:
                new_inst = resample(new_inst, seq_len)
            sub_batch[b, 0] = new_inst
        return sub_batch


class IEWindowWarping(IEWindowWarpingBase):
    """Randomly warps either the I or E limb per breath
    (reference: augmentation.py:150-165)."""

    def __call__(self, sub_batch, rng=None):
        rng = rng or np.random.default_rng()
        choices = rng.choice([True, False], size=sub_batch.shape[0])
        return self.warp(sub_batch, choices, rng)


class IEWindowWarpingIEProgrammable(IEWindowWarpingBase):
    """(reference: augmentation.py:129-147)"""

    def __init__(self, rate_lower_bound, rate_upper_bound, probability,
                 use_i):
        super().__init__(rate_lower_bound, rate_upper_bound, probability)
        self.use_i = use_i

    def __call__(self, sub_batch, rng=None):
        choices = [self.use_i] * sub_batch.shape[0]
        return self.warp(sub_batch, choices, rng)


def build_transforms(names, probability, use_i=False):
    """Compose transforms from CLI names
    (reference: train_ards_detector.py:175-187).

    ``names`` may be a list (CLI nargs) or a single string (reference
    yml files write ``transforms: ie_ww_i_or_e``); a bare string becomes
    a one-element list, or the membership tests below would degrade to
    substring matches ("ie_ww" in "ie_ww_i_or_e" is True).
    """
    if isinstance(names, str):
        names = [names]
    transforms = []
    if "ie_ww" in names:
        transforms.append(IEWindowWarping(0.5, 2, probability))
    if "naive_ww" in names:
        transforms.append(NaiveWindowWarping(0.5, 2, probability))
    if "ie_ww_i_or_e" in names:
        transforms.append(
            IEWindowWarpingIEProgrammable(0.5, 2, probability, use_i)
        )
    return Compose(transforms)


def apply_to_batch(transforms, data, rng):
    """Apply per-sample transforms to a gathered (B, S, C, L) batch."""
    out = np.array(data, copy=True)
    for i in range(out.shape[0]):
        out[i] = transforms(out[i], rng)
    return out
