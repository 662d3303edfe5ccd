"""Per-batch normalization on the device.

Counterpart of the normalize path of ``deepards_tpu/data/pipeline.py``
(``transform_batch``, ``BatchPipeline``, ``gather_pipeline``): raw windows
are scaled by the training fold's (mu, std) inside the train and eval
steps, so data reaches the device once, unnormalized.  The JAX package's
other batch transforms (Butterworth filtering, post-hoc FFT downsampling,
FFT band filtering) are not ported yet: a dataset that asks for one
raises ``NotImplementedError``.
"""
import numpy as np
import torch


def transform_batch(data, mu, std, is_padded=False, zero_mu=False):
    """Normalize a raw batch (B, S, C, L) by per-channel (C,) mu and std.

    - padded dataset types subtract mu only where data != 0, so the zero
      padding stays zero before scaling
      (reference: deepards/dataset.py:1375-1379, 1406-1409)
    - zero_mu forces mu = 0, as the JAX package does when augmentation
      transforms are active (reference: deepards/dataset.py:1371-1373)
    """
    if zero_mu:
        mu = torch.zeros_like(mu)
    mu_b = mu.reshape(1, 1, -1, 1)
    std_b = std.reshape(1, 1, -1, 1)
    if is_padded:
        return torch.where(data != 0, (data - mu_b) / std_b, data / std_b)
    return (data - mu_b) / std_b


class BatchPipeline:
    """A dataset's normalization for the current fold as one callable on
    ``device``: built once per (dataset, fold), it holds mu and std there."""

    def __init__(self, dataset, device="cpu"):
        unported = [
            name for name, value in (
                ("butter_low", dataset.butter_low),
                ("butter_high", dataset.butter_high),
                ("post_hoc_downsampling", dataset.post_hoc_downsampling),
                ("fft_filtering_low", dataset.fft_filtering_low),
                ("fft_filtering_high", dataset.fft_filtering_high),
            ) if value is not None
        ]
        if unported:
            raise NotImplementedError(
                "batch transforms not ported to deepards_tpu_torch yet: "
                + ", ".join(unported))
        self.is_padded = "padded_breath_by_breath" in dataset.dataset_type
        self.zero_mu = dataset.transforms is not None
        mu, std = dataset.scaling_for_current_fold()
        self.mu = torch.as_tensor(np.asarray(mu, np.float32)).to(device)
        self.std = torch.as_tensor(np.asarray(std, np.float32)).to(device)

    def __call__(self, data):
        return transform_batch(data, self.mu, self.std,
                               is_padded=self.is_padded,
                               zero_mu=self.zero_mu)


def gather_pipeline(dataset):
    """Normalization for windows gathered on the host (numpy in, numpy
    out), for surfaces that feed ``dataset.gather`` rows straight to a
    model: ``gather`` returns raw rows, while the model was trained on
    normalized ones."""
    pipe = BatchPipeline(dataset)

    def apply(x):
        x = np.asarray(x, np.float32)
        squeeze = x.ndim == 3  # single (S, C, L) window
        if squeeze:
            x = x[None]
        out = pipe(torch.from_numpy(x)).numpy()
        return out[0] if squeeze else out

    return apply
