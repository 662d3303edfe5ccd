"""``chip_smoke.py``'s sequence phase rehearsed on the CPU, and the server
over a nested network.

- ``sort_mode``, which makes the card take the CPU's sort picks: a
  replayed sort picks the recorded elements (over permuted rows too) and
  sends their gradient there, and the card's own sort stays within its
  bound while a sort one rank off does not;
- ``nested_padding`` at full width (densenet18, S = 20): a patient's real
  windows' logits padded and at their own bucket within 1e-5, and its
  planted faults (windows reversed; no window mask) caught;
- the server scores each patient's windows of a request as one super
  batch, as the model scores the padded, masked patient.
"""
import numpy as np
import pytest
import torch

import chip_smoke
from deepards_tpu_torch.cli.serve import DROPOUT_SEED, InferenceEngine
from deepards_tpu_torch.models.registry import (
    get_base_network,
    get_network_spec,
)
from deepards_tpu_torch.train import checkpoint

# parallel test workers share the cores: one torch thread each
torch.set_num_threads(1)


def test_sort_mode_replays_the_recorded_picks():
    cpu = torch.tensor([0.1, 0.5, 0.3, 0.9, 0.30001],
                       dtype=torch.float64)[None, :, None]
    card = cpu.clone()
    card[0, 4] = 0.29999  # windows 2 and 4 change places
    records = []
    with chip_smoke.sort_mode(records):
        torch.sort(cpu, dim=1)
    x = card.clone().requires_grad_()
    gaps = []
    with chip_smoke.sort_mode([], replay=records, gaps=gaps):
        lower = torch.sort(x, dim=1).values[:, 2]
    # the lower median is the CPU's window 4, at the card's value, and the
    # gradient goes to it (the card's own sort picks window 2)
    assert lower.item() == 0.29999
    lower.sum().backward()
    assert x.grad.flatten().tolist() == [0, 0, 0, 0, 1]
    # the card's own sort within twice its input's distance from the
    # CPU's; a sort one rank off beyond it
    (gap,) = gaps
    assert gap["own"] == pytest.approx(1e-5)
    assert gap["own"] <= gap["bound"] == pytest.approx(4e-5)
    assert gap["rank_off"] == pytest.approx(0.8)


@pytest.mark.parametrize("nested", [False, True])
def test_replayed_picks_follow_permuted_rows(nested):
    x = torch.from_numpy(np.random.default_rng(0).normal(size=(4, 6, 3)))
    permuted = np.array([2, 0, 3, 1, 5, 4])[:4 if not nested else 6]
    records = []
    with chip_smoke.sort_mode(records):
        want = torch.sort(x, dim=1).values
    rows = x[:, permuted] if nested else x[permuted]
    with chip_smoke.sort_mode([], replay=records,
                              remap=chip_smoke.remapped(permuted, nested)):
        got = torch.sort(rows, dim=1).values
    assert torch.equal(got, want if nested else want[permuted])


@pytest.mark.parametrize("name", ["cnn_to_nested_lstm",
                                  "cnn_to_nested_transformer"])
def test_nested_padding_check_on_the_cpu(tmp_path, name):
    fields = chip_smoke.nested_padding(str(tmp_path), "cpu", name)
    assert fields["max_abs"] <= chip_smoke.NESTED_ATOL
    assert fields["planted_max_abs"] > chip_smoke.NESTED_ATOL


def test_server_scores_each_patient_as_a_super_batch(tmp_path):
    conf = {"base_network": "densenet18"}
    model = get_network_spec("cnn_to_nested_transformer").build(
        conf, get_base_network(conf), 4).reset_parameters(
            torch.Generator().manual_seed(0))
    path = str(tmp_path / "nested")
    checkpoint.save(path, model.state_dict())
    engine = InferenceEngine(path, network="cnn_to_nested_transformer",
                             n_sub_batches=4, device="cpu")
    windows = np.random.default_rng(1).normal(
        size=(7, 4, 1, 224)).astype(np.float32)
    patients = ["b", "a", "b", "b", "a", "b", "b"]
    probs = engine.predict(windows, patients)
    for patient, bucket in (("a", 2), ("b", 8)):
        rows = [i for i, p in enumerate(patients) if p == patient]
        x = torch.zeros((1, bucket, 4, 1, 224))
        x[0, :len(rows)] = torch.from_numpy(windows[rows])
        mask = torch.arange(bucket)[None] < len(rows)
        with torch.no_grad():
            out = model(x, False, torch.Generator().manual_seed(
                DROPOUT_SEED), window_mask=mask)
        want = torch.softmax(out[0, :len(rows)], dim=-1).numpy()
        np.testing.assert_allclose(probs[rows], want, atol=1e-6, rtol=0)
    # without patients: all the windows one patient
    alone = engine.predict(windows[[1, 4]])
    np.testing.assert_allclose(alone, probs[[1, 4]], atol=1e-6, rtol=0)
