"""``deepards_tpu_torch.cli.predict`` on the CPU.

- Against the JAX forward: the JAX package's cnn_linear/densenet18
  params saved as an ``.npz`` of flat params, the fold's test windows
  normalized by the JAX ``BatchPipeline``, chunks of 8 zero-padded with
  the pad rows masked out of the norms, dropout off on both sides,
  float32: probabilities atol 1e-5, predictions and votes equal.
- Against the trainer: probabilities of a trained checkpoint equal,
  bit for bit, the trainer's eval of the same checkpoint
  (``--load-checkpoint ... --no-train``), dropout on: both draw the
  masks from the checkpoint's generator.  The vote fractions are equal;
  the trainer's record votes OTHER on a tie, predict's JSON ARDS, as in
  the JAX package.
"""
import csv
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deepards_tpu.data.dataset import ARDSRawDataset as JaxDataset
from deepards_tpu.data.pipeline import BatchPipeline as JaxPipeline
from deepards_tpu.models import densenet1d as jdn
from deepards_tpu.models import heads as jheads
from deepards_tpu.models.layers import bn_row_mask
from deepards_tpu_torch.cli import predict as tpredict
from deepards_tpu_torch.config.config import Configuration
from deepards_tpu_torch.train import loop as tloop

torch.set_num_threads(1)

S, BATCH = 4, 8


def _flags(cohort, tmp_path, *extra):
    return ["--data-path", cohort["data_path"], "--cohort-file",
            cohort["cohort_file"], "--n-sub-batches", str(S),
            "--batch-size", str(BATCH), "--kfolds", "2", "--only-fold", "1",
            "--dataset-type", "unpadded_centered_sequences", "--seed", "7",
            "--results-dir", str(tmp_path / "results"), "--device", "cpu",
            *extra]


def _no_dropout(make_train_step):
    def wrapped(*args, **kw):
        kw["dropout_active"] = False
        kw["eval_dropout_active"] = False
        return make_train_step(*args, **kw)
    return wrapped


def _jax_probs(cohort, params):
    """The JAX forward over fold 1's test windows, in chunks of 8."""
    train = JaxDataset(cohort["data_path"], 1, cohort["cohort_file"], S,
                       "unpadded_centered_sequences", kfold_num=0,
                       total_kfolds=2, seed=7)
    test = JaxDataset.make_test_dataset_if_kfold(train)
    test.set_kfold_indexes_for_fold(1)
    pipe = JaxPipeline(test)
    model = jheads.CNNLinearNetwork(breath_block=jdn.densenet18())
    idx = test.current_indices()
    probs = []
    for start in range(0, len(idx), BATCH):
        data = test.gather(idx[start:start + BATCH])["data"]
        n = len(data)
        mask = np.zeros(BATCH, np.float32)
        mask[:n] = 1.0
        data = np.concatenate(
            [data, np.zeros((BATCH - n,) + data.shape[1:], data.dtype)])
        with bn_row_mask(jnp.repeat(jnp.asarray(mask), S)):
            out = model.apply({"params": params}, pipe(jnp.asarray(data)),
                              None, True)
        probs.append(np.asarray(jax.nn.softmax(out, axis=-1))[:n])
    return idx, np.concatenate(probs)


def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if hasattr(v, "items"):
            out.update(_flat(v, prefix + k + "/"))
        else:
            out[prefix + k] = np.asarray(v)
    return out


def test_predict_matches_the_jax_forward(synthetic_cohort, tmp_path,
                                         monkeypatch):
    model = jheads.CNNLinearNetwork(breath_block=jdn.densenet18())
    params = model.init({"params": jax.random.PRNGKey(3)},
                        jnp.zeros((2, S, 1, 224)), None, True)["params"]
    path = str(tmp_path / "jax_params.npz")
    np.savez(path, **_flat(params))
    idx, want = _jax_probs(synthetic_cohort, params)

    monkeypatch.setattr(tpredict, "make_train_step",
                        _no_dropout(tpredict.make_train_step))
    out, votes_out = tmp_path / "p.csv", tmp_path / "v.json"
    rows, votes = tpredict.main(
        ["--checkpoint", path, "-o", str(out), "--votes-output",
         str(votes_out)]
        + _flags(synthetic_cohort, tmp_path, "--compute-dtype", "float32"))
    with open(out) as f:
        written = list(csv.DictReader(f))
    assert list(written[0]) == tpredict.WINDOW_COLUMNS
    assert [int(r["window_index"]) for r in written] == idx.tolist()
    got = np.array([[float(r["prob_other"]), float(r["prob_ards"])]
                    for r in written])
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=0)
    assert [int(r["prediction"]) for r in written] == \
        want.argmax(axis=1).tolist()
    with open(votes_out) as f:
        assert json.load(f) == votes
    assert [list(v) for v in votes] == [
        ["patient", "pred_frac", "n_windows", "prediction"]] * len(votes)
    patients = [r["patient"] for r in written]
    assert [v["patient"] for v in votes] == sorted(set(patients))
    for v in votes:
        mine = [p == v["patient"] for p in patients]
        frac = float(want.argmax(axis=1)[mine].mean())
        assert v["pred_frac"] == frac and v["n_windows"] == sum(mine)
        assert v["prediction"] == int(frac >= 0.5)


def test_predict_equals_the_trainers_eval(synthetic_cohort, tmp_path):
    from deepards_tpu_torch.cli.train import main as train_main

    models = str(tmp_path / "models")
    train_main(_flags(synthetic_cohort, tmp_path, "--epochs", "1",
                      "--save-model", "m.pt", "--saved-models-dir", models))
    path = models + "/m-fold1"
    rows, votes = tpredict.main(
        ["--checkpoint", path, "-o", str(tmp_path / "p.csv"),
         "--votes-output", str(tmp_path / "v.json")]
        + _flags(synthetic_cohort, tmp_path))
    evaluated = train_main(_flags(
        synthetic_cohort, tmp_path, "--epochs", "1", "--no-train",
        "--load-checkpoint", path))
    logits = torch.from_numpy(evaluated.last_eval["logits"])
    assert [r["window_index"] for r in rows] == \
        evaluated.last_eval["index"].tolist()
    got = np.array([[r["prob_other"], r["prob_ards"]] for r in rows])
    np.testing.assert_array_equal(
        got, torch.softmax(logits, dim=-1).numpy().astype(np.float64))
    records = {r["patient"]: r for r in evaluated.results.results}
    assert len(records) == len(votes)
    for v in votes:
        assert v["pred_frac"] == records[v["patient"]]["pred_frac"]
        if v["pred_frac"] != 0.5:
            assert v["prediction"] == records[v["patient"]]["prediction"]


def test_predict_defaults_to_the_card(synthetic_cohort, tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    conf = Configuration(overrides={"data_path": str(tmp_path)})
    with pytest.raises(RuntimeError, match="CUDA"):
        tpredict.predict(conf, str(tmp_path / "missing.pt"))
    assert isinstance(tloop.make_trainer(conf, device="cpu"), tloop.Trainer)
