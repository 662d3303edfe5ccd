"""The explain CLIs on the CPU against the JAX package's.

``cli.patient_gradcam`` and ``cli.protopnet_analysis`` through
``main(argv)`` on one saved ``.npz`` dataset (the seeded cohort of
``test_torch_patient_gradcam.py``, 2 folds) that both packages read: the
JAX CLIs restore an orbax checkpoint saved with
``deepards_tpu.train.checkpoint.save``, the port's an ``.npz`` of the same
flax params (``transplant``).  The files each writes are compared as in
``test_torch_patient_gradcam.py`` (arrays within 1e-5 of max(1, |x|),
records equal), ``-tp``'s features within 1e-5.  Both CLIs cam the fold's
test patients, whatever the JAX CLI's help says.
"""
import os
import pickle
from types import SimpleNamespace

import jax
import numpy as np
import pytest
import torch
from flax import traverse_util
from test_torch_patient_gradcam import (
    PATIENTS,
    assert_elbows,
    assert_same_files,
    close,
    cnn_linear,
    save_cohort,
    tree,
)
from test_torch_prototypes import jit_apply_in_place, ppnets

from deepards_tpu.cli import patient_gradcam as jcli_gradcam
from deepards_tpu.cli import protopnet_analysis as jcli_protopnet
from deepards_tpu.explain import patient_gradcam as jpatient
from deepards_tpu.explain import prototypes as jprototypes
from deepards_tpu.models import protopnet1d as jprotopnet
from deepards_tpu.train import checkpoint as jckpt
from deepards_tpu_torch.cli import patient_gradcam as cli_gradcam
from deepards_tpu_torch.cli import protopnet_analysis as cli_protopnet
from deepards_tpu_torch.data.dataset import ARDSRawDataset
from deepards_tpu_torch.utils import figures

# parallel test workers share the cores: one torch thread each
torch.set_num_threads(1)


def save_both(root, name, params):
    """(orbax checkpoint for the JAX CLI, .npz of flat params for the
    port's)."""
    jax_path = jckpt.save(os.path.join(root, name), SimpleNamespace(
        params=params, opt_state={}, rng=jax.random.PRNGKey(0), step=0))
    port_path = os.path.join(root, name + ".npz")
    np.savez(port_path, **traverse_util.flatten_dict(params, sep="/"))
    return jax_path or os.path.join(root, name), port_path


@pytest.fixture(scope="module")
def saved(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("explain_cli"))
    data = save_cohort(root, total_kfolds=2)
    _, cam_params, _ = cnn_linear()
    _, ppnet_params, _ = ppnets()
    return {"root": root, "data": data,
            "cnn_linear": save_both(root, "cnn_linear", cam_params),
            "ppnet": save_both(root, "ppnet", ppnet_params)}


@pytest.fixture(autouse=True)
def no_plots(monkeypatch):
    monkeypatch.setattr(jpatient, "_get_plt", lambda: None)
    monkeypatch.setattr(jprototypes, "_get_plt", lambda: None)
    monkeypatch.setattr(figures, "refusal",
                        lambda device: "matplotlib is missing")


def _test_patients(path, fold):
    ds = ARDSRawDataset.from_pickle(path)
    ds.set_kfold_indexes_for_fold(fold)
    test = ARDSRawDataset.make_test_dataset_if_kfold(ds)
    test.set_kfold_indexes_for_fold(fold)
    return set(test.get_ground_truth().patient.tolist())


@pytest.mark.parametrize("args", [
    ["--ops", "medians", "--fold", "1"],
    ["--ops", "dtw_clust", "--fold", "1", "--only-patient", "05"],
    ["--ops", "rand_sample", "--fold", "1", "-shuf"],
    ["--ops", "cam_by_hour", "--fold", "0", "--hour-start", "6",
     "--hour-end", "19", "--seqs-per-hour", "1", "--target", "both"],
])
def test_patient_gradcam_cli_matches_jax(saved, tmp_path, args):
    jax_ckpt, port_ckpt = saved["cnn_linear"]
    common = ["-pdp", saved["data"], "--results-base-dir"]
    jcli_gradcam.main([jax_ckpt] + common + [str(tmp_path / "jax")] + args)
    out = cli_gradcam.main([port_ckpt] + common + [str(tmp_path / "port")]
                           + args + ["--device", "cpu"])
    if "dtw_clust" in args:
        assert "05" in _test_patients(saved["data"], 1)
        assert list(out) == [("05", 0)]
        assert_elbows(str(tmp_path / "port"), str(tmp_path / "jax"),
                      distortions=False, patients=[("05", 0)])
        return
    assert_same_files(str(tmp_path / "port"), str(tmp_path / "jax"))
    if "medians" in args:
        # the fold's test patients, as in the reference
        written = {os.path.splitext(os.path.basename(p))[0]
                   for p in tree(str(tmp_path / "port"))}
        assert written == _test_patients(saved["data"], 1) != set(PATIENTS)


def test_patient_gradcam_cli_refuses_a_patient_outside_the_fold(saved,
                                                                tmp_path):
    _, port_ckpt = saved["cnn_linear"]
    outside = next(p for p in PATIENTS
                   if p not in _test_patients(saved["data"], 0))
    with pytest.raises(SystemExit, match="not in fold 0"):
        cli_gradcam.main([port_ckpt, "-pdp", saved["data"], "--fold", "0",
                          "--ops", "medians", "--only-patient", outside,
                          "--results-base-dir", str(tmp_path),
                          "--device", "cpu"])


def test_protopnet_analysis_cli_matches_jax(saved, tmp_path, monkeypatch):
    """The pane's record equal, ``-tp``'s features and probabilities
    within 1e-5 and its columns and rows the JAX frames'."""
    construct = jprotopnet.construct_ppnet
    monkeypatch.setattr(jprotopnet, "construct_ppnet",
                        lambda *a, **kw: jit_apply_in_place(
                            construct(*a, **kw)))
    jax_ckpt, port_ckpt = saved["ppnet"]
    args = ["--kfold-from-pickle", saved["data"], "--kfold-idx", "1",
            "--n-prototypes", "2", "--topk", "5", "--seed", "3"]
    jcli_protopnet.main([jax_ckpt, "-o", str(tmp_path / "jax"), "-tp",
                         str(tmp_path / "jax.pkl")] + args)
    analysis, base = cli_protopnet.main(
        [port_ckpt, "-o", str(tmp_path / "port"), "-tp",
         str(tmp_path / "port.pkl"), "--device", "cpu"] + args)
    assert_same_files(str(tmp_path / "port"), str(tmp_path / "jax"))
    assert os.path.exists(base + ".txt")
    with open(tmp_path / "port.pkl", "rb") as f:
        got = pickle.load(f)
    with open(tmp_path / "jax.pkl", "rb") as f:
        want = pickle.load(f)
    assert sorted(got) == sorted(
        list(want) + ["train_index", "test_index", "feature_names"])
    for split in ("train", "test"):
        frame = want[split + "_features"]
        close(got[split + "_features"], frame.to_numpy())
        assert got["feature_names"] == list(frame.columns)
        np.testing.assert_array_equal(got[split + "_index"],
                                      frame.index.to_numpy())
        close(got[split + "_preds"], want[split + "_preds"])
    np.testing.assert_array_equal(got["coefs"], want["coefs"])
    np.testing.assert_array_equal(analysis.test_features,
                                  got["test_features"])
    assert set(analysis.test_gt.patient.tolist()) == \
        _test_patients(saved["data"], 1)
