"""The port's data axis (``deepards_tpu_torch/parallel/mesh.py``) on the
CPU against the JAX package's mesh.

- ``shard_batch``: the pad, the mask and each rank's rows equal the JAX
  ``shard_batch``'s shards on 2 of the 8 forced CPU devices;
- the placement rule equals ``shard_state``'s specs on the cases of
  ``tests/test_trainer_features.py::test_shard_state_head_dense_rules``;
- one float64 step of config 1, of config 5's ProtoPNet joint stage and
  of config 1 at ``bn_scope='sequence'`` with one sample a rank over 2
  ranks (``tests/torch_sharded_steps.py``) equals the step in one
  process: every gradient within 1e-9 of its tensor's largest element
  (the first norm's scale cancels over its rows by ~1e5);
- ``make_data_axis`` by process count, and the model axis refused (the
  single-process runs against the JAX package are in
  ``test_torch_distributed_runs.py``);
- two ranks through ``cli.launch_distributed --device cpu`` (gloo), on
  the shared synthetic cohort: an eval-only fold equals the
  single-process ``dp_devices=2`` fold (AUC exact, losses rtol 1e-5,
  atol 1e-6), and a trained fold with a checkpoint after every step
  (rank 0 writes them) has the first step's gradient (the SGD momentum
  buffer, no clamp) of the single-process run, every element within
  1e-5 of the gradient's largest, and the
  trained losses within 1e-3, as ``tests/test_multiprocess.py`` claims
  for the JAX package.  Both ranks write the same meters and rows.
"""
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import chip_smoke
from deepards_tpu.parallel import mesh as jmesh
from deepards_tpu_torch.cli import train as train_cli
from deepards_tpu_torch.config.config import Configuration
from deepards_tpu_torch.parallel import mesh
from deepards_tpu_torch.train import checkpoint
from deepards_tpu_torch.train import loop as tloop

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.mark.parametrize("rows", [4, 5, 7])
def test_shard_batch_matches_jax(rows):
    jax_mesh = jmesh.make_mesh(dp_devices=2)
    rng = np.random.default_rng(rows)
    batch = {"data": rng.normal(size=(rows, 3, 1, 8)).astype(np.float32),
             "target": rng.uniform(size=(rows, 2)).astype(np.float32)}
    want, want_mask = jmesh.shard_batch(jax_mesh, batch)

    def shards(x):
        return [np.asarray(s.data) for s in sorted(
            x.addressable_shards, key=lambda s: s.index[0].start or 0)]

    for rank in (0, 1):
        got, mask = mesh.shard_batch(mesh.DataAxis(2, rank, 2), batch)
        np.testing.assert_array_equal(mask, shards(want_mask)[rank])
        for key in batch:
            np.testing.assert_array_equal(got[key], shards(want[key])[rank])
    # one process holds every shard
    whole, mask = mesh.shard_batch(mesh.DataAxis(2), batch)
    np.testing.assert_array_equal(mask, np.asarray(want_mask))
    np.testing.assert_array_equal(whole["data"], np.asarray(want["data"]))


def test_placement_matches_shard_state():
    """The port's names and (out, in) layout: a flax kernel's spec
    reversed."""
    jax_mesh = jmesh.make_mesh(dp_devices=4, model_devices=2)
    shape = dict(jax_mesh.shape)
    cases = [("Dense_0", "kernel", (8, 2), "head.weight"),
             ("Dense_0", "bias", (2,), "head.bias"),
             ("breath_block", "w", (3, 3), "breath_block.w"),
             ("Dense_0", "kernel", (8, 3), "head.weight")]
    for module, leaf, dims, name in cases:
        tree = {module: {leaf: np.zeros(dims, np.float32)}}
        placed = jmesh.shard_state(jax_mesh, tree,
                                   rules=jmesh.HEAD_DENSE_MODEL_RULES)
        want = tuple(placed[module][leaf].sharding.spec)
        torch_dims = dims[::-1]
        got = mesh.placement(name, torch_dims, shape,
                             mesh.HEAD_DENSE_MODEL_RULES)
        assert got == want[::-1], name
    assert mesh.placement("head.weight", (2, 8),
                          {mesh.DATA_AXIS: 8, mesh.MODEL_AXIS: 1},
                          mesh.HEAD_DENSE_MODEL_RULES) == ()


def test_data_axis_by_process_count(monkeypatch):
    assert mesh.make_data_axis(-1) == mesh.DataAxis(1, 0, 1)
    assert mesh.make_data_axis(3) == mesh.DataAxis(3, 0, 1)
    assert mesh.DataAxis(3).pad_target(5) == 6
    assert mesh.DataAxis(2, 1, 2).local(6) == slice(3, 6)
    with pytest.raises(ValueError, match="dp_devices=-2"):
        mesh.make_data_axis(-2)
    monkeypatch.setattr(mesh, "process_count", lambda: 2)
    monkeypatch.setattr(mesh, "process_index", lambda: 1)
    assert mesh.make_data_axis(-1) == mesh.DataAxis(2, 1, 2)
    assert mesh.make_data_axis(1) == mesh.DataAxis(1, 0, 1)
    with pytest.raises(ValueError, match="dp_devices=4: a run of 2"):
        mesh.make_data_axis(4)


def test_model_axis_is_refused(synthetic_cohort, tmp_path):
    with pytest.raises(NotImplementedError, match="model_devices=2"):
        tloop.Trainer(Configuration(overrides=dict(
            data_path=synthetic_cohort["data_path"], network="cnn_linear",
            model_devices=2, results_dir=str(tmp_path))), device="cpu")


# -- two processes ------------------------------------------------------------


def _flags(cohort, **extra):
    flags = ["--data-path", cohort["data_path"], "--cohort-file",
             cohort["cohort_file"], "-n", "cnn_linear", "--base-network",
             "densenet18", "-nb", "4", "--kfolds", "2", "--only-fold", "0",
             "--epochs", "1", "--batch-size", "5", "--compute-dtype",
             "float32", "--seed", "7", "--oversample-minority", "-lr",
             "0.0001"]
    for key, value in extra.items():
        flags += ["--" + key.replace("_", "-")] + (
            [] if value is True else [str(value)])
    return flags


def _launch(cohort, out, coordinator=None, **extra):
    """Two ranks through the launcher, over gloo on a free port (the
    launcher's own without ``coordinator``), each with one torch thread;
    returns their results dirs."""
    env = dict(os.environ, OMP_NUM_THREADS="1",
               PYTHONPATH=REPO + os.pathsep + os.environ.get(
                   "PYTHONPATH", ""), **{train_cli.LAUNCH_COUNTS_ENV: "1"})
    cmd = [sys.executable, "-m", "deepards_tpu_torch.cli.launch_distributed",
           "-n", "2", "--device", "cpu", "--results-dir", str(out)]
    if coordinator:
        cmd += ["--coordinator", coordinator]
    cmd += ["--"] + _flags(cohort, **extra)
    proc = subprocess.Popen(cmd, cwd=str(out.parent), env=env,
                            stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                            text=True)
    try:
        stdout, stderr = proc.communicate(timeout=120)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.communicate()
    assert proc.returncode == 0, stderr[-3000:]
    assert "all 2 ranks completed" in stdout
    dirs = [str(out / "rank{}".format(r)) for r in (0, 1)]
    # each rank's own count of hand-written kernel launches (none on
    # the CPU, where the DTW wrapper runs its plain version)
    assert [chip_smoke.rank_launches(os.path.join(
        d, train_cli.LAUNCH_COUNTS_FILE)) for d in dirs] == [0, 0]
    return dirs


def _single(cohort, out, **extra):
    """The same fold in this process at dp_devices=2 (the whole padded
    batch of 6 at once), through the CLI's parser."""
    return train_cli.main(_flags(cohort, **extra) + [
        "--dp-devices", "2", "--device", "cpu", "--results-dir", str(out)])


def _assert_ranks_equal(dirs):
    """The ranks' meters and patient rows, equal; rank 0's."""
    (m0, r0), (m1, r1) = (chip_smoke.dist_saved(d) for d in dirs)
    assert m0.keys() == m1.keys() and r0 == r1 and r0
    for key in m0:
        np.testing.assert_array_equal(m0[key], m1[key], err_msg=key)
    return m0, r0


def test_two_processes_match_one(synthetic_cohort, tmp_path):
    # eval only: the fold's fixed init over the test split
    dirs = _launch(synthetic_cohort, tmp_path / "eval", no_train=True)
    meters, rows = _assert_ranks_equal(dirs)
    one = _single(synthetic_cohort, tmp_path / "eval1", no_train=True)
    assert rows == one.results.results
    for key, got in meters.items():
        want = one.results.reporting.meters[key].values
        if "auc" in key:
            assert list(got) == want, key
        else:
            np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6,
                                       err_msg=key)
    # trained, a checkpoint after every step (no clamp: the momentum
    # buffer after step 1 is the gradient plus the weight decay)
    models = tmp_path / "models"
    extra = dict(save_model="m", checkpoint_every_n_steps=1,
                 fused_steps=1, saved_models_dir=models)
    dirs = _launch(synthetic_cohort, tmp_path / "train",
                   "127.0.0.1:{}".format(chip_smoke.free_port()), **extra)
    meters, _ = _assert_ranks_equal(dirs)
    step1 = checkpoint.restore(str(models / "m-epoch1-fold0-step1"))
    extra["saved_models_dir"] = tmp_path / "models1"
    one = _single(synthetic_cohort, tmp_path / "train1", **extra)
    want1 = checkpoint.restore(str(tmp_path / "models1" /
                                   "m-epoch1-fold0-step1"))
    got = {k: v["momentum_buffer"].numpy()
           for k, v in step1["opt_state"]["state"].items()}
    want = {k: v["momentum_buffer"].numpy()
            for k, v in want1["opt_state"]["state"].items()}
    assert got.keys() == want.keys() and got
    # every element within 1e-5 of the gradient's largest: the first
    # norm's scale has a gradient of ~1e-6 that cancels over its N*L
    # rows, where the two sums' float32 roundings part by ~3e-8
    scale = max(np.abs(w).max() for w in want.values())
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=0,
                                   atol=1e-5 * scale, err_msg=str(k))
    for key in ("loss_fold_0", "test_loss_fold_0"):
        np.testing.assert_allclose(
            meters[key], one.results.reporting.meters[key].values,
            atol=1e-3, rtol=0, err_msg=key)


@pytest.mark.parametrize("network", ["config1", "config5",
                                     "config1_sequence"])
def test_sharded_float64_step_matches_one_process(tmp_path, network):
    import torch_sharded_steps

    want, want_loss = torch_sharded_steps.step_gradients(network)
    out = str(tmp_path / "ranks.npz")
    port = str(chip_smoke.free_port())
    env = dict(os.environ, OMP_NUM_THREADS="1", PYTHONPATH=REPO)
    procs = [subprocess.Popen(
        [sys.executable, torch_sharded_steps.__file__, str(rank), port,
         network, out], cwd=REPO, env=env, stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True) for rank in (0, 1)]
    try:
        logs = [p.communicate(timeout=120)[0] for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
    assert [p.returncode for p in procs] == [0, 0], logs
    with np.load(out) as got:
        np.testing.assert_allclose(got["loss"], want_loss, rtol=1e-12)
        assert len(got.files) == len(want) + 1
        for name, grad in want.items():
            np.testing.assert_allclose(
                got[name.replace(".", "/")], grad, rtol=0,
                atol=1e-9 * np.abs(grad).max(), err_msg=name)
