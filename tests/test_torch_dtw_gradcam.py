"""DTW-aligned GradCAM on the CPU against the JAX package.

``diagonal_runs`` and ``dtw_cam_match`` (the path through the port's
``dtw_full``, the last-match-wins matches, the runs and their cam sums)
equal on the same breaths and cams; ``find_similar_cam_regions`` over a
patient of the seeded cohort of ``test_torch_patient_gradcam.py`` with
cnn_linear/densenet18 (numpy-drawn params carried over with
``transplant``): the same windows drawn, their cams held as in
``test_torch_gradcam.py``, the same pairs kept, cam distances within 1e-5
of max(1, |x|).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_gradcam import _maxmin_scaled, _uint8_equal
from test_torch_patient_gradcam import PATIENTS, close, cnn_linear, save_cohort

from deepards_tpu.data.dataset import ARDSRawDataset as JaxDataset
from deepards_tpu.explain import dtw_gradcam as jdtw_gradcam
from deepards_tpu.explain import gradcam as jgradcam
from deepards_tpu_torch.data.dataset import ARDSRawDataset
from deepards_tpu_torch.explain import dtw_gradcam, gradcam

# parallel test workers share the cores: one torch thread each
torch.set_num_threads(1)


@pytest.mark.parametrize("px,py,min_run", [
    ([0, 1, 2, 3, 4, 5, 6, 7], [0, 1, 2, 3, 4, 5, 6, 7], 5),
    ([0, 1, 2, 2, 3, 4, 5, 6, 7, 8, 9, 9, 9], [0, 1, 2, 3, 4, 5, 6, 7, 8,
                                               9, 10, 11, 12], 3),
    ([0, 0, 1, 2, 3, 4, 5, 6, 6, 7], [0, 1, 2, 3, 4, 5, 6, 6, 7, 8], 2),
    ([0, 1], [0, 1], 0),
])
def test_diagonal_runs_match_jax(px, py, min_run):
    assert dtw_gradcam.diagonal_runs(px, py, min_run) == \
        jdtw_gradcam.diagonal_runs(px, py, min_run)


@pytest.mark.parametrize("n,m,seed", [(40, 40, 0), (30, 45, 1), (50, 20, 2)])
def test_dtw_cam_match_matches_jax(n, m, seed):
    """Breaths with repeated values (vertical and horizontal moves, ties)
    and float cams with sub-integer values."""
    rng = np.random.default_rng(seed)
    br1 = np.round(rng.normal(size=n) * 3).astype(np.float32)
    br2 = np.round(rng.normal(size=m) * 3).astype(np.float32)
    cam1 = rng.uniform(0, 255, size=n).astype(np.float32)
    cam2 = rng.uniform(0, 0.9, size=m).astype(np.float32)
    got = dtw_gradcam.dtw_cam_match(br1, br2, cam1, cam2, min_run=2)
    want = jdtw_gradcam.dtw_cam_match(br1, br2, cam1, cam2, min_run=2)
    assert got["distance"] == want["distance"]
    np.testing.assert_array_equal(got["cost_matrix"], want["cost_matrix"])
    for a, b in zip(got["path"], want["path"]):
        np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(got["cam_dists"], want["cam_dists"])
    assert got["runs"] == want["runs"] and got["runs"]


@pytest.fixture(scope="module")
def cohort(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("dtw_gradcam"))
    path = save_cohort(root, n_windows=3)
    return ARDSRawDataset.from_pickle(path), JaxDataset.from_pickle(path)


class Replay:
    """A cam generator that returns the cams another one gave."""

    def __init__(self, cams, outs):
        self.cams, self.outs = cams, outs

    def generate_read_cams_batch(self, xs, targets):
        return self.cams, self.outs


@pytest.mark.parametrize("variant", ["MaxMinNormCam", "UnNormalizedCam"])
def test_find_similar_cam_regions_matches_jax(cohort, variant):
    """UnNormalizedCam's float cams straight through both packages;
    MaxMinNormCam's uint8 cams equal but within rounding of a step (one
    here), so the JAX function then runs on the port's cams."""
    ds, jds = cohort
    jmodel, params, model = cnn_linear()
    kw = dict(n_windows=2, max_cam_dist=150, min_cam1_sum=100, min_run=5)
    if variant == "UnNormalizedCam":
        kw.update(max_cam_dist=1e9, min_cam1_sum=0.0)
    cam = getattr(gradcam, variant)(model)
    calls = []

    def recorded(xs, targets):
        calls.append((xs, targets, *type(cam).generate_read_cams_batch(
            cam, xs, targets)))
        return calls[-1][2:]
    cam.generate_read_cams_batch = recorded
    pairs, dists = dtw_gradcam.find_similar_cam_regions(
        cam, ds, PATIENTS[1], 1, rng=np.random.default_rng(7), **kw)
    jcam = getattr(jgradcam, variant)(jmodel, params)
    (xs, targets, cams, outs), = calls
    want_cams, _ = jcam.generate_read_cams_batch(xs, targets)
    if variant == "MaxMinNormCam":
        raw, _ = jcam._batch_cam(jnp.asarray(xs), jnp.asarray(targets))
        _uint8_equal(cams, want_cams, _maxmin_scaled(np.asarray(raw)))
        jcam = Replay(cams, outs)
    else:
        close(cams, want_cams)
    want_pairs, want_dists = jdtw_gradcam.find_similar_cam_regions(
        jcam, jds, PATIENTS[1], 1, rng=np.random.default_rng(7), **kw)
    close(dists, want_dists)
    assert len(dists) > len(pairs) == len(want_pairs) > 0
    for got, want in zip(pairs, want_pairs):
        assert (got["window_i"], got["window_j"]) == \
            (want["window_i"], want["window_j"])
        np.testing.assert_allclose(got["br1"], want["br1"], atol=1e-6)
        np.testing.assert_allclose(got["br2"], want["br2"], atol=1e-6)
        assert got["run"]["seq1"] == want["run"]["seq1"]
        assert got["run"]["seq2"] == want["run"]["seq2"]
        close(got["run"]["cam_dist"], want["run"]["cam_dist"])
        close(got["run"]["cam1_sum"], want["run"]["cam1_sum"])
