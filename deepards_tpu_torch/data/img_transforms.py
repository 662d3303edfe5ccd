"""2D (image) augmentations for breath-image datasets.

A copy of ``deepards_tpu/data/img_transforms.py``: numpy and scipy only,
kept in the port so that it imports nothing of the JAX package.  The
reference's row/window transform family (reference:
deepards/dataset.py:108-340): RowShuffle, RandomRowHorizontalFlip,
RandomRowScale, magnitude/time warping, window warping/slicing, plain
horizontal/vertical flips and RandomErasing; the registry
``two_dim_transforms`` mirrors :330-340.

All transforms take numpy images shaped (C, H, W) (rows = H) and draw
from the ``rng`` passed in, in the JAX package's order, so the same seed
gives the same images bit for bit.
"""
import numpy as np
from scipy.interpolate import CubicSpline


class _RandomTransform:
    def __init__(self, p=0.5):
        self.p = p

    def __call__(self, x, rng=None):
        rng = rng or np.random.default_rng()
        if self.p < rng.random():
            return x
        return self.apply(np.array(x, copy=True), rng)


class RowShuffle(_RandomTransform):
    """(reference: dataset.py:240-254)"""

    def apply(self, x, rng):
        idxs = rng.permutation(x.shape[1])
        return x[:, idxs]


class RandomRowHorizontalFlip(_RandomTransform):
    """(reference: dataset.py:257-275)"""

    def __init__(self, p=0.5, frac_rows=0.25):
        super().__init__(p)
        self.frac_rows = frac_rows

    def apply(self, x, rng):
        h = x.shape[1]
        idxs = rng.permutation(h)[: int(h * self.frac_rows)]
        x[:, idxs] = x[:, idxs, ::-1]
        return x


class RandomRowScale(_RandomTransform):
    """(reference: dataset.py:278-296)"""

    def __init__(self, p=0.5, frac_rows=0.25, mag=(0.8, 1.2)):
        super().__init__(p)
        self.frac_rows = frac_rows
        self.mag = mag

    def apply(self, x, rng):
        h = x.shape[1]
        n = int(h * self.frac_rows)
        idxs = rng.permutation(h)[:n]
        warp = rng.uniform(self.mag[0], self.mag[1], size=n)[:, None]
        x[:, idxs] = x[:, idxs] * warp
        return x


class RandomHorizontalFlip(_RandomTransform):
    def apply(self, x, rng):
        return x[:, :, ::-1]


class RandomVerticalFlip(_RandomTransform):
    def apply(self, x, rng):
        return x[:, ::-1, :]


def magnitude_warp(x, rng, sigma=0.2, knot=4):
    """Smooth random magnitude envelope, drawn per (channel, row) in the
    reference's shape and call order: one normal draw of shape
    (C, knot+2, H), one spline per row (reference: dataset.py:108-121
    with its (batch, time, chans) mapped to our (C, W, H) view)."""
    c, h, w = x.shape
    orig = np.arange(w)
    warp_steps = np.linspace(0, w - 1.0, num=knot + 2)
    rand = rng.normal(1.0, sigma, size=(c, knot + 2, h))
    for ci in range(c):
        for hi in range(h):
            warper = CubicSpline(warp_steps, rand[ci, :, hi])(orig)
            x[ci, hi] = x[ci, hi] * warper
    return x


def time_warp(x, rng, sigma=0.2, knot=4):
    """Per-(channel, row) time warp, draws shape-exact with the
    reference (reference: dataset.py:123-138)."""
    c, h, w = x.shape
    orig = np.arange(w)
    warp_steps = np.linspace(0, w - 1.0, num=knot + 2)
    rand = rng.normal(1.0, sigma, size=(c, knot + 2, h))
    for ci in range(c):
        for hi in range(h):
            tw = CubicSpline(warp_steps, warp_steps * rand[ci, :, hi])(orig)
            scale = (w - 1) / tw[-1]
            warped_t = np.clip(scale * tw, 0, w - 1)
            x[ci, hi] = np.interp(orig, warped_t, x[ci, hi])
    return x


def window_slice(x, rng, reduce_ratio=0.9):
    """Per-channel slice starts, as the reference draws them
    (reference: dataset.py:140-155, size=(batch,) == our C)."""
    c, h, w = x.shape
    target_len = int(np.ceil(reduce_ratio * w))
    if target_len >= w:
        return x
    starts = rng.integers(0, w - target_len, size=c)
    for ci in range(c):
        start = int(starts[ci])
        for hi in range(h):
            seg = x[ci, hi, start : start + target_len]
            x[ci, hi] = np.interp(
                np.linspace(0, target_len, num=w),
                np.arange(target_len), seg,
            )
    return x


def window_warp(x, rng, window_ratio=0.25, scales=(0.5, 2.0),
                by_row=False):
    """Window warp with the reference's draw shapes and order: scales
    first (per channel, or per row with by_row), then per-channel window
    starts (reference: dataset.py:157-180)."""
    c, h, w = x.shape
    warp_scales = rng.choice(scales, size=h if by_row else c)
    warp_size = int(np.ceil(window_ratio * w))
    steps = np.arange(warp_size)
    starts = rng.integers(1, w - warp_size - 1, size=c)
    for ci in range(c):
        start = int(starts[ci])
        end = start + warp_size
        for hi in range(h):
            scale = float(warp_scales[hi if by_row else ci])
            row = x[ci, hi]
            mid = np.interp(
                np.linspace(0, warp_size - 1.0,
                            num=int(warp_size * scale)),
                steps, row[start:end],
            )
            warped = np.concatenate([row[:start], mid, row[end:]])
            x[ci, hi] = np.interp(
                np.arange(w),
                np.linspace(0, w - 1.0, num=warped.size), warped,
            )
    return x


class RandomMagnitudeWarp(_RandomTransform):
    def apply(self, x, rng):
        return magnitude_warp(x, rng)


class RandomTimeWarp(_RandomTransform):
    def apply(self, x, rng):
        return time_warp(x, rng)


class RandomWindowSlicing(_RandomTransform):
    def __init__(self, p=0.5, reduce_ratio=0.9):
        super().__init__(p)
        self.reduce_ratio = reduce_ratio

    def apply(self, x, rng):
        return window_slice(x, rng, self.reduce_ratio)


class RandomWindowWarping(_RandomTransform):
    def __init__(self, p=0.5, window_ratio=0.25, scales=(0.5, 2.0),
                 by_row=False):
        super().__init__(p)
        self.window_ratio = window_ratio
        self.scales = scales
        self.by_row = by_row

    def apply(self, x, rng):
        return window_warp(x, rng, self.window_ratio, self.scales,
                           self.by_row)


class RandomErasing(_RandomTransform):
    """Zero out a random rectangle (torchvision RandomErasing semantics;
    the reference's rand_erase experiment yml names this transform even
    though reference dataset.py:330-340 dropped it from the registry —
    kept here so that experiment file stays loadable)."""

    def __init__(self, p=0.5, scale=(0.02, 0.33), ratio=(0.3, 3.3)):
        super().__init__(p)
        self.scale = scale
        self.ratio = ratio

    def apply(self, x, rng):
        c, h, w = x.shape
        area = h * w
        for _ in range(10):
            target = rng.uniform(*self.scale) * area
            aspect = np.exp(rng.uniform(np.log(self.ratio[0]),
                                        np.log(self.ratio[1])))
            eh = int(round(np.sqrt(target * aspect)))
            ew = int(round(np.sqrt(target / aspect)))
            if eh < h and ew < w:
                i = rng.integers(0, h - eh + 1)
                j = rng.integers(0, w - ew + 1)
                x[:, i:i + eh, j:j + ew] = 0.0
                return x
        return x


# (reference: dataset.py:330-340)
two_dim_transforms = {
    "rand_erase": RandomErasing,
    "row_shuffle": RowShuffle,
    "row_horiz_flip": RandomRowHorizontalFlip,
    "horiz_flip": RandomHorizontalFlip,
    "vert_flip": RandomVerticalFlip,
    "scale": RandomRowScale,
    "mag_warp": RandomMagnitudeWarp,
    "win_warp": RandomWindowWarping,
    "win_slice": RandomWindowSlicing,
    "time_warp": RandomTimeWarp,
}
