"""Autocorrelation-peak linearity score.

Gates the ``drop_if_under_r2`` dataset filter
(reference: deepards/correlation.py:26-52 AutoCorrelation.get_auto_corr_r2,
consumed at deepards/dataset.py:1323-1326): autocorrelate the window,
smooth, take the positive local peaks, and return the r² of a linear fit
over peak index → peak value.  Periodic, regular breathing yields high r².

A copy of ``deepards_tpu/data/correlation.py``: pure numpy/scipy, kept in the port
so that it imports nothing of the JAX package.
"""
import numpy as np
from scipy.ndimage import gaussian_filter1d


def autocorr_r2(seq):
    seq = np.asarray(seq, dtype=np.float64)
    ac = np.correlate(seq, seq, mode="same")[: len(seq) // 2]
    ac = gaussian_filter1d(ac, 10)
    # positive local maxima (reference peak_func uses a 2-step lookahead)
    peaks = [
        v
        for i, v in enumerate(ac[1:-1])
        if ac[i] < v and (i + 2 >= len(ac) or v > ac[i + 2]) and v > 0
    ]
    filt = np.array([ac[0]] + peaks + [ac[-1]])
    if len(filt) < 3:
        return 0.0
    x = np.arange(len(filt), dtype=np.float64)
    # r² of OLS y ~ a + b·x is the squared pearson correlation
    vx = x - x.mean()
    vy = filt - filt.mean()
    denom = np.sqrt((vx ** 2).sum() * (vy ** 2).sum())
    if denom == 0:
        return 0.0
    return float(((vx * vy).sum() / denom) ** 2)
