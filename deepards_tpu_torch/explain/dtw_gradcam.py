"""DTW-aligned GradCAM comparison.

Counterpart of ``deepards_tpu/explain/dtw_gradcam.py`` (reference:
scripts/exploratory/dtw_grad_cam.py:1-158): warp two breaths onto each
other with DTW, walk the optimal path, take its diagonal runs (stretches
where both breaths advance in lockstep), and compare the cams along the
matched samples.  A low cam distance over a strongly activated run means
the model attends to the same region of both breaths.

The cams of all sampled windows run in one batched pass on the cam's
device; each pair's path is extracted on the host by ``ops.dtw.dtw_full``
(a sequential backtrack over one pair).
"""
import numpy as np

from deepards_tpu_torch.data.pipeline import gather_pipeline
from deepards_tpu_torch.explain.gradcam import upsample_cam
from deepards_tpu_torch.ops.dtw import dtw_full


def diagonal_runs(path_x, path_y, min_run=5):
    """Runs of breath 1's indexes where the warping path moves diagonally
    (slope 1) for more than ``min_run`` samples
    (reference: dtw_grad_cam.py:79-91)."""
    px = np.asarray(path_x)
    py = np.asarray(path_y)
    runs = []
    cur = []
    for k in range(1, len(px)):
        if px[k] - px[k - 1] == 1 and py[k] - py[k - 1] == 1:
            if not cur:
                cur = [int(px[k - 1])]
            cur.append(int(px[k]))
        else:
            if len(cur) > min_run:
                runs.append(cur)
            cur = []
    if len(cur) > min_run:
        runs.append(cur)
    return runs


def dtw_cam_match(br1, br2, cam1, cam2, min_run=5):
    """Warp br2 onto br1 and compare cams along the matched samples.

    Returns {distance, cost_matrix, path, cam_dists, runs}: the DTW
    distance, the per-sample cam distance over the path, and per diagonal
    run its br1 indexes, the matched br2 indexes, its summed cam distance
    and its summed cam1 (the reference keeps runs with cam_dist <= 15 and
    sum(cam1[run]) > 100, dtw_grad_cam.py:136-139)."""
    d, cost, (px, py) = dtw_full(br1, br2)
    # last match wins: the reference builds the matches as a dict
    # (dtw_grad_cam.py:69), so a br1 index revisited by a vertical move
    # keeps its last br2 partner
    matches = {int(x): int(y) for x, y in zip(px, py)}
    # float cams: UnNormalizedCam's sub-integer values would truncate to 0
    cam1 = np.asarray(cam1, np.float64).ravel()
    cam2 = np.asarray(cam2, np.float64).ravel()
    cam_dists = np.asarray([abs(cam1[i] - cam2[matches[i]])
                            for i in sorted(matches)])
    runs = []
    for run in diagonal_runs(px, py, min_run):
        runs.append({
            "seq1": run,
            "seq2": [matches[i] for i in run],
            "cam_dist": float(sum(abs(cam1[i] - cam2[matches[i]])
                                  for i in run)),
            "cam1_sum": float(cam1[run].sum()),
        })
    return {"distance": d, "cost_matrix": cost, "path": (px, py),
            "cam_dists": cam_dists, "runs": runs}


def find_similar_cam_regions(cam_gen, dataset, patient_id, target,
                             n_windows=6, max_cam_dist=15,
                             min_cam1_sum=100, min_run=5, rng=None):
    """Sample ``n_windows`` windows of one patient, align every pair of
    their breaths with DTW, and keep the lockstep runs where both cams
    agree and breath 1's cam is strongly active
    (reference: dtw_grad_cam.py:109-140).

    ``cam_gen`` exposes ``generate_read_cams_batch`` (MaxMin,
    UnNormalized).  Returns (pairs, all run cam distances)."""
    rng = rng or np.random.default_rng(0)
    gt = dataset.get_ground_truth()
    idxs = gt.index[gt.patient == patient_id]
    pick = rng.choice(idxs, size=min(n_windows, len(idxs)), replace=False)
    # the cams run at the scale the checkpoint was trained at
    data = gather_pipeline(dataset)(dataset.gather(pick)["data"])
    cams, _ = cam_gen.generate_read_cams_batch(
        data, np.full(len(data), target))  # (W, S, L')
    cams224 = upsample_cam(cams.reshape(-1, cams.shape[-1]))
    breaths = data[:, :, 0, :].reshape(-1, data.shape[-1])

    pairs = []
    all_cam_dists = []
    n = len(breaths)
    for i in range(n):
        for j in range(i + 1, n):
            res = dtw_cam_match(breaths[i], breaths[j], cams224[i],
                                cams224[j], min_run=min_run)
            for run in res["runs"]:
                all_cam_dists.append(run["cam_dist"])
                if (run["cam_dist"] <= max_cam_dist
                        and run["cam1_sum"] > min_cam1_sum):
                    pairs.append({"window_i": i, "window_j": j,
                                  "br1": breaths[i], "br2": breaths[j],
                                  "run": run})
    return pairs, np.asarray(all_cam_dists)
