"""Per-batch transforms on the device.

Counterpart of ``deepards_tpu/data/pipeline.py`` (``design_butter_sos``,
``sosfilt``, ``fft_resample``, ``fft_band_filter``, ``transform_batch``,
``BatchPipeline``, ``gather_pipeline``): raw windows are scaled by the
training fold's (mu, std), then optionally Butterworth-filtered,
downsampled by FFT resampling and re-padded, and FFT band-filtered, inside
the train and eval steps, so data reaches the device once, unnormalized
(reference: deepards/dataset.py:1343-1404).

``sosfilt``: the JAX package scans the cascaded biquads over the L
samples.  With zero initial state and a fixed L the filter is a linear
map, y = x @ T with T[j, i] = h[i - j] for i >= j, where h is the
cascade's impulse response over L samples.  ``sosfilt_matrix`` builds T
once with scipy in float64 (from the float32 taps the JAX package filters
with); a batch is then one (rows, L) x (L, L) product, with TF32 off, in
place of L sequential steps.
"""
import numpy as np
import scipy.signal
import torch
import torch.nn.functional as F


def design_butter_sos(butter_low, butter_high, fs=50.0, order=10):
    """Host-side SOS design with the reference's dispatch
    (reference: deepards/dataset.py:546-559).  Returns an (n_sections, 6)
    float32 array, or None."""
    butter = scipy.signal.butter
    if butter_low is not None and butter_high is None:
        sos = butter(order, butter_low, fs=fs, output="sos", btype="lowpass")
    elif butter_low == 0:
        sos = butter(order, butter_high, fs=fs, output="sos", btype="lowpass")
    elif butter_low is None and butter_high is not None:
        sos = butter(order, butter_high, fs=fs, output="sos", btype="highpass")
    elif butter_high == 25:
        sos = butter(order, butter_low, fs=fs, output="sos", btype="highpass")
    elif butter_low is not None and butter_high is not None:
        sos = butter(order, (butter_low, butter_high), fs=fs, output="sos",
                     btype="bandpass")
    else:
        return None
    return np.asarray(sos, dtype=np.float32)


def sosfilt_matrix(sos, length):
    """(L, L) float64 T with ``x @ T`` = scipy.signal.sosfilt(sos, x) along
    the last axis, zero initial state: T[j, i] = h[i - j] for i >= j."""
    impulse = np.zeros(length)
    impulse[0] = 1.0
    h = scipy.signal.sosfilt(np.asarray(sos, np.float64), impulse)
    lag = np.arange(length)[None, :] - np.arange(length)[:, None]
    return np.where(lag >= 0, h[np.maximum(lag, 0)], 0.0)


def _matmul_no_tf32(x, m):
    """x @ m in full float32 on the card, whatever the global TF32 flag."""
    prev = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        return torch.matmul(x, m)
    finally:
        torch.backends.cuda.matmul.allow_tf32 = prev


def sosfilt(sos, x):
    """Cascaded-biquad IIR filter along the last axis, zero initial
    state, as one product with ``sosfilt_matrix``."""
    matrix = torch.as_tensor(sosfilt_matrix(sos, x.shape[-1]),
                             dtype=x.dtype, device=x.device)
    return _matmul_no_tf32(x, matrix)


def fft_resample(x, new_len):
    """scipy.signal.resample (FFT method) along the last axis."""
    n = x.shape[-1]
    xf = torch.fft.rfft(x, dim=-1)
    nyq = new_len // 2 + 1
    if new_len < n:
        xf = xf[..., :nyq]
        if new_len % 2 == 0:
            # scipy folds the conjugate half onto the nyquist bin when
            # downsampling to an even length: double it to match
            xf = torch.cat([xf[..., :nyq - 1], xf[..., nyq - 1:] * 2],
                           dim=-1)
    elif new_len > n:
        if n % 2 == 0:
            # scipy halves the nyquist bin when upsampling an even length
            xf = torch.cat([xf[..., :n // 2], xf[..., n // 2:] * 0.5],
                           dim=-1)
        pad = xf.new_zeros(xf.shape[:-1] + (nyq - xf.shape[-1],))
        xf = torch.cat([xf, pad], dim=-1)
    return torch.fft.irfft(xf, n=new_len, dim=-1) * (new_len / n)


def band_mask(n, low, high, fs=50.0):
    """(n,) bool: the FFT bins strictly between ``low`` and ``high`` Hz."""
    freqs = np.fft.fftfreq(n, d=1.0 / fs)
    return (np.abs(freqs) > low) & (np.abs(freqs) < high)


def fft_band_filter(x, low, high, fs=50.0):
    """Zero the frequency bins outside (low, high) Hz
    (reference: deepards/dataset.py:1393-1400)."""
    mask = torch.as_tensor(band_mask(x.shape[-1], low, high, fs),
                           dtype=x.dtype, device=x.device)
    return _masked_spectrum(x, mask)


def _masked_spectrum(x, mask):
    """x with its FFT bins weighted by ``mask`` (0/1, x's dtype)."""
    return torch.fft.ifft(torch.fft.fft(x, dim=-1) * mask, dim=-1).real


def transform_batch(data, mu, std, is_padded=False, zero_mu=False,
                    sos_matrix=None, post_hoc_downsampling=None,
                    band_mask=None):
    """Normalize and filter a raw batch (B, S, C, L) by per-channel (C,)
    mu and std.

    - padded dataset types subtract mu only where data != 0, so the zero
      padding stays zero before scaling
      (reference: deepards/dataset.py:1375-1379, 1406-1409)
    - zero_mu forces mu = 0, as the JAX package does when augmentation
      transforms are active (reference: deepards/dataset.py:1371-1373)
    - sos_matrix: Butterworth filtering (``sosfilt_matrix`` in data's
      dtype on its device)
    - post_hoc_downsampling: FFT-resample to L / factor samples, then
      zero-pad back to L (reference: deepards/dataset.py:1384-1391)
    - band_mask: FFT band filtering (``band_mask`` as 0/1 in data's dtype
      on its device)
    """
    if zero_mu:
        mu = torch.zeros_like(mu)
    mu_b = mu.reshape(1, 1, -1, 1)
    std_b = std.reshape(1, 1, -1, 1)
    if is_padded:
        data = torch.where(data != 0, (data - mu_b) / std_b, data / std_b)
    else:
        data = (data - mu_b) / std_b
    if sos_matrix is not None:
        data = _matmul_no_tf32(data, sos_matrix)
    if post_hoc_downsampling is not None:
        old_len = data.shape[-1]
        new_len = int(old_len / post_hoc_downsampling)
        data = F.pad(fft_resample(data, new_len), (0, old_len - new_len))
    if band_mask is not None:
        data = _masked_spectrum(data, band_mask)
    return data


class BatchPipeline:
    """A dataset's transforms for the current fold as one callable on
    ``device``: built once per (dataset, fold), it holds mu, std, the
    filter matrix and the band mask there, so a step copies nothing from
    the host."""

    def __init__(self, dataset, device):
        self.is_padded = "padded_breath_by_breath" in dataset.dataset_type
        self.zero_mu = dataset.transforms is not None
        mu, std = dataset.scaling_for_current_fold()
        self.mu = torch.as_tensor(np.asarray(mu, np.float32)).to(device)
        self.std = torch.as_tensor(np.asarray(std, np.float32)).to(device)
        length = dataset.cache.data.shape[-1]
        sos = design_butter_sos(dataset.butter_low, dataset.butter_high)
        self.sos_matrix = None if sos is None else torch.as_tensor(
            sosfilt_matrix(sos, length), dtype=torch.float32).to(device)
        self.post_hoc_downsampling = dataset.post_hoc_downsampling
        low, high = dataset.fft_filtering_low, dataset.fft_filtering_high
        self.band_mask = None if low is None or high is None else (
            torch.as_tensor(band_mask(length, low, high),
                            dtype=torch.float32).to(device))

    def __call__(self, data):
        return transform_batch(
            data, self.mu, self.std, is_padded=self.is_padded,
            zero_mu=self.zero_mu, sos_matrix=self.sos_matrix,
            post_hoc_downsampling=self.post_hoc_downsampling,
            band_mask=self.band_mask)


def gather_pipeline(dataset):
    """The batch transforms for windows gathered on the host (numpy in,
    numpy out), for surfaces that feed ``dataset.gather`` rows straight to
    a model: ``gather`` returns raw rows, while the model was trained on
    transformed ones."""
    pipe = BatchPipeline(dataset, "cpu")

    def apply(x):
        x = np.asarray(x, np.float32)
        squeeze = x.ndim == 3  # single (S, C, L) window
        if squeeze:
            x = x[None]
        out = pipe(torch.from_numpy(x)).numpy()
        return out[0] if squeeze else out

    return apply
