"""``cli.predict`` of a nested network, in both packages.

The JAX ``cli/predict.py`` feeds the test windows in chunks of
``batch_size`` (16): a (16, S, C, L) chunk is 4-D, which the nested
network reads as one patient's W = 16 windows (``models/nested.py``), so
a chunk cuts patients apart and joins them, its (1, 16, 2) probabilities
are averaged to one row, and the loop over the chunk's windows fails at
its second window (IndexError) -- pinned here.  The port predicts a
nested network as its trainer evaluates it, one patient's windows a
super batch: its probabilities equal those of the trainer's eval of the
same checkpoint (``--load-checkpoint --no-train``), window by window,
with the same votes.
"""
import numpy as np
import pytest
import torch

from deepards_tpu.cli.predict import predict as jax_predict
from deepards_tpu.config import Configuration as JaxConfiguration
from deepards_tpu.train.loop import make_trainer as jax_make_trainer
from deepards_tpu_torch.cli.predict import predict
from deepards_tpu_torch.config.config import Configuration
from deepards_tpu_torch.data.synthetic import generate_cohort
from deepards_tpu_torch.train.loop import make_trainer

# parallel test workers share the cores: one torch thread each
torch.set_num_threads(1)


@pytest.fixture(scope="module")
def cohort(tmp_path_factory):
    data_path = str(tmp_path_factory.mktemp("nested_predict"))
    cohort_file = generate_cohort(data_path, n_patients=8,
                                  n_breaths_per_patient=60, seed=17)
    return {"data_path": data_path, "cohort_file": cohort_file}


def _overrides(cohort, tmp_path, **over):
    base = dict(
        data_path=cohort["data_path"], cohort_file=cohort["cohort_file"],
        experiment_num=1, network="cnn_to_nested_lstm",
        base_network="resnet18", initial_planes=8,
        dataset_type="unpadded_centered_sequences", n_sub_batches=4,
        kfolds=2, only_fold=0, epochs=1, batch_size=16,
        compute_dtype="float32", results_dir=str(tmp_path / "results"),
        seed=5, debug=True, save_model="nm",
        saved_models_dir=str(tmp_path / "models"))
    base.update(over)
    return base


def test_jax_nested_predict_scores_chunks_as_patients(cohort, tmp_path):
    conf = JaxConfiguration(overrides=_overrides(cohort, tmp_path))
    jax_make_trainer(conf, verbose=False).train_and_test()
    with pytest.raises(IndexError, match="index 1 is out of bounds"):
        jax_predict(conf, str(tmp_path / "models" / "nm-fold0"), 16)


def test_port_nested_predict_equals_the_trainers_eval(cohort, tmp_path):
    over = _overrides(cohort, tmp_path)
    make_trainer(Configuration(overrides=over), device="cpu",
                 verbose=False).train_and_test()
    path = str(tmp_path / "models" / "nm-fold0")
    conf = Configuration(overrides=over)
    rows, votes = predict(conf, path, 16, device="cpu")
    evaluated = make_trainer(Configuration(overrides=_overrides(
        cohort, tmp_path / "eval", load_checkpoint=path, no_train=True,
        save_model=None, debug=False)), device="cpu", verbose=False)
    evaluated.train_and_test()
    logits = torch.from_numpy(evaluated.last_eval["logits"])
    want = torch.softmax(logits, dim=-1).numpy()
    got = np.array([[r["prob_other"], r["prob_ards"]] for r in rows])
    assert [r["window_index"] for r in rows] == \
        evaluated.last_eval["index"].tolist()
    np.testing.assert_allclose(got, want, atol=1e-6, rtol=0)
    # patients in sorted order, one super batch each
    patients = [r["patient"] for r in rows]
    assert patients == sorted(patients)
    records = {r["patient"]: r for r in evaluated.results.results}
    assert len(records) == len(votes) > 1
    for vote in votes:
        assert vote["pred_frac"] == records[vote["patient"]]["pred_frac"]
