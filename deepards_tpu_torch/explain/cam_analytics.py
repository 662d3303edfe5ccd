"""GradCAM analytics: cluster-count search, PCA and its scatter by
cluster count, cluster prototypes, and the cams' spectral energy by band.

Counterpart of ``deepards_tpu/explain/cam_analytics.py`` (reference:
deepards/gradcam.py:268-1062), on numpy alone: the silhouette is written
out to scikit-learn's definition, and tables are dicts of columns (name ->
list or array) under the JAX package's column names.  The scatter is
drawn with matplotlib on the CPU host only (``utils/figures.py``).
"""
import os

import numpy as np

from deepards_tpu_torch.data.pipeline import gather_pipeline
from deepards_tpu_torch.utils import figures


def _kmeans(x, k, iters=50, seed=0):
    """Lloyd's KMeans labels: the JAX package's dependency-free one
    (``deepards_tpu/cli/create_datasets.py`` ``_kmeans``)."""
    rng = np.random.default_rng(seed)
    x = np.asarray(x, np.float64)
    k = min(k, len(x))
    centers = x[rng.choice(len(x), k, replace=False)]
    for _ in range(iters):
        d = ((x[:, None] - centers[None]) ** 2).sum(-1)
        labels = d.argmin(1)
        new = np.array([
            x[labels == j].mean(0) if (labels == j).any() else centers[j]
            for j in range(k)
        ])
        if np.allclose(new, centers):
            break
        centers = new
    return labels


def _kmeans_fit(X, k, seed=0):
    labels = _kmeans(X, k, seed=seed)
    centers = np.stack([
        X[labels == j].mean(axis=0) if (labels == j).any()
        else np.zeros(X.shape[1])
        for j in range(k)
    ])
    inertia = float(((X - centers[labels]) ** 2).sum())
    return labels, centers, inertia


def _euclidean_distances(X):
    """Pairwise distances as scikit-learn computes them for float64:
    -2<x, y> + ||x||^2 + ||y||^2, clamped at 0, the diagonal set to 0."""
    X = np.asarray(X, np.float64)
    sq = np.einsum("ij,ij->i", X, X)
    d2 = -2 * (X @ X.T)
    d2 += sq[:, None]
    d2 += sq[None, :]
    np.maximum(d2, 0, out=d2)
    np.fill_diagonal(d2, 0)
    return np.sqrt(d2)


def silhouette_score(X, labels):
    """Mean silhouette coefficient, scikit-learn's
    ``metrics.silhouette_score(X, labels)``: per sample, a = mean distance
    to the others of its cluster, b = least mean distance to another
    cluster, s = (b - a) / max(a, b), 0 in a cluster of one.  Raises
    ValueError unless 2 <= number of labels <= n_samples - 1, as it
    does."""
    labels = np.unique(np.asarray(labels), return_inverse=True)[1].ravel()
    n = len(labels)
    n_labels = labels.max() + 1 if n else 0
    if not 1 < n_labels < n:
        raise ValueError(
            "Number of labels is {}. Valid values are 2 to n_samples - 1 "
            "(inclusive)".format(n_labels))
    freqs = np.bincount(labels)
    D = _euclidean_distances(X)
    sums = np.stack([np.bincount(labels, weights=row, minlength=n_labels)
                     for row in D])  # (n, n_labels)
    intra = sums[np.arange(n), labels]
    sums[np.arange(n), labels] = np.inf
    inter = (sums / freqs).min(axis=1)
    with np.errstate(divide="ignore", invalid="ignore"):
        intra = intra / (freqs - 1)[labels]
        sil = (inter - intra) / np.maximum(intra, inter)
    return float(np.mean(np.nan_to_num(sil)))


def kmean_clust_search(X, max_clusts=10, nrefs=3, seed=0):
    """Elbow distortions and inertias, silhouettes and the
    gap-statistic-optimal cluster count over k = 2..max_clusts-1
    (reference: gradcam.py:268-332).  Returns (distortions, inertias,
    silhouettes, best_k, {clusterCount, gap})."""
    X = np.asarray(X, np.float64)
    rng = np.random.default_rng(seed)
    ks = list(range(2, max_clusts))
    distortions, inertias, sil, gaps = [], [], [], []
    for k in ks:
        labels, centers, inertia = _kmeans_fit(X, k, seed)
        d = np.sqrt(((X[:, None] - centers[None]) ** 2).sum(-1))
        distortions.append(float(d.min(axis=1).mean()))
        inertias.append(inertia)
        try:
            sil.append(silhouette_score(X, labels))
        except ValueError:
            sil.append(0.0)
        ref_disps = []
        for r in range(nrefs):
            ref = rng.random(X.shape)
            ref_disps.append(_kmeans_fit(ref, k, seed + r + 1)[2])
        gaps.append(
            float(np.log(np.mean(ref_disps)) - np.log(max(inertia, 1e-12))))
    best_k = int(np.argmax(gaps)) + 2
    return distortions, inertias, sil, best_k, {"clusterCount": ks,
                                               "gap": gaps}


def pca_2d(X):
    """2-component PCA coordinates (reference: gradcam.py:334-343)."""
    X = np.asarray(X, np.float64)
    Xc = X - X.mean(axis=0)
    _, _, vt = np.linalg.svd(Xc, full_matrices=False)
    return Xc @ vt[:2].T


def pca_clusters(X, max_k=6, seed=0):
    """(the 2-component PCA coordinates of ``X``, {k: KMeans labels} for
    k = 2..max_k-1): the data behind ``viz_pca_clustering``."""
    X = np.asarray(X, np.float64)
    return pca_2d(X), {k: _kmeans_fit(X, k, seed)[0]
                       for k in range(2, max_k)}


def _draw_pca(path, coords, labels):
    plt = figures.pyplot()
    fig, axes = plt.subplots(1, len(labels), figsize=(3.2 * len(labels), 3))
    for ax, (k, lab) in zip(np.atleast_1d(axes), labels.items()):
        for i in range(k):
            m = lab == i
            ax.scatter(coords[m, 0], coords[m, 1], s=8)
        ax.set_title("k={}".format(k))
    fig.savefig(path, dpi=120, bbox_inches="tight")
    plt.close(fig)
    return path


def viz_pca_clustering(X, out_path=None, max_k=6, seed=0, device="cpu"):
    """The cams' PCA scatter coloured by KMeans cluster, one panel a k
    (``deepards_tpu/explain/cam_analytics.py:69-85``): with ``out_path``
    an ``.npz`` of ``pca_clusters`` beside it and, where ``device`` is
    the CPU host and matplotlib is present, the PNG.  Returns
    ``out_path``."""
    coords, labels = pca_clusters(X, max_k, seed)
    if out_path:
        np.savez(os.path.splitext(out_path)[0] + ".npz", coords=coords,
                 **{"labels_k{}".format(k): v for k, v in labels.items()})
        figures.draw_or_refuse([(out_path, lambda path: _draw_pca(
            path, coords, labels))], device)
    return out_path


def cluster_prototypes(X, n_clust, dataset, sequence_map, seed=0):
    """Per cluster, the window whose cam row lies closest to the centroid
    (reference: gradcam.py:346-374)."""
    X = np.asarray(X, np.float64)
    labels, centers, _ = _kmeans_fit(X, n_clust, seed)
    d = np.sqrt(((X[:, None] - centers[None]) ** 2).sum(-1))  # (N, K)
    closest = d.argmin(axis=0)
    out = []
    for k in range(n_clust):
        true_idx = int(sequence_map[int(closest[k])])
        out.append({
            "cluster": k,
            "window_index": true_idx,
            "sequence": dataset.cache.data[true_idx],
            "n_members": int((labels == k).sum()),
        })
    return out


BANDS = {"0-2Hz": (0.0, 2.0), "2-8Hz": (2.0, 8.0), "8-25Hz": (8.0, 25.0)}


def frequency_band_analytics(cams_by_patho, fs=50.0):
    """Per pathophysiology, the summed mean |FFT| of its cams in each band
    of ``BANDS`` (reference: gradcam.py:376-1062, condensed):
    {patho (the keys, a list), 0-2Hz, 2-8Hz, 8-25Hz}, a row a
    pathophysiology."""
    table = {"patho": list(cams_by_patho), **{b: [] for b in BANDS}}
    for cams in cams_by_patho.values():
        cams = np.asarray(cams, np.float64)
        if cams.size == 0:
            for name in BANDS:
                table[name].append(0.0)
            continue
        n = cams.shape[-1]
        freqs = np.fft.rfftfreq(n, d=1.0 / fs * (224.0 / n))
        spec = np.abs(np.fft.rfft(cams, axis=-1)).mean(axis=0)
        for name, (lo, hi) in BANDS.items():
            m = (freqs >= lo) & (freqs < hi)
            table[name].append(float(spec[m].sum()) if m.any() else 0.0)
    return {name: table[name] if name == "patho" else np.asarray(col)
            for name, col in table.items()}


def collect_cams(cam_generator, dataset, max_windows=64):
    """The cams of the first ``max_windows`` current windows, each at its
    own class, with their window indices and classes.  The windows go
    through the fold's transforms first.  Each row's class is read by
    position, so a window the oversampler repeated is read once per
    repeat."""
    pipeline = gather_pipeline(dataset)
    gt = dataset.get_ground_truth()
    X, seq_map = [], []
    for idx, target in zip(gt.index[:max_windows], gt.y[:max_windows]):
        window = pipeline(dataset.cache.data[int(idx)])
        cam, _ = cam_generator.generate_cam(window, int(target))
        X.append(np.asarray(cam, np.float64))
        seq_map.append(int(idx))
    return (np.stack(X), seq_map,
            np.asarray(gt.y[:max_windows], np.int64))
