"""Each network's reference is found by its name alone.

The pinned numbers are the reference's own at a cut size on the CPU in
float32 (two threads, as ``bench_tiny`` sets), as they stood while each
network's forward lived in one module beside the shared backbone: the
initial weights' bytes, the FLOP counts, three train steps (losses,
first gradients, changes, gradient norms) plain, in float8 and with half
of each step left out, and a test epoch's logits.  A change to how the
reference finds or runs a network has to give them bit for bit.  A
stand-in network that no cell uses then runs through the same calls
from its own module alone.
"""
import hashlib
import os
import sys
import textwrap

import numpy as np
import pytest
import torch

import bench_tiny  # noqa: F401  (puts the repository on the path)
from benchmark import weights as weights_lib
from benchmark.reference import flops, folds, networks, runs
from benchmark.reference.precision import fp8_e4m3

S = 2
HYPER = {"lr": 1e-3, "weight_decay": 1e-4, "clip": 0.01}
MU, STD = np.array([0.5]), np.array([2.0])

PINS = {
    "cnn_linear": {
        "weights": "89db5732f67286c2",
        "flops": {(2, True): 66808832, (2, False): 22336512,
                  (20, True): 668088320, (20, False): 223365120},
        "train": (["0x1.86680a0000000p-1", "0x1.693ed40000000p-1",
                   "0x1.9ad5fa0000000p-1"],
                  "830a7053f02a2fd0", "8e6d266e4b9586bf", "00cda5e3d75cdc6a"),
        "train_fp8": (["0x1.81d4ac0000000p-1"], "2b20a26049c03d90",
                      "3d1a4f978eae8281", "8de1c6a77b573f99"),
        "train_half": (["0x1.8d89020000000p-1", "0x1.61063a0000000p-1"],
                       "9a85ed235c8e8f57", "d47755b53bfd66b7",
                       "1a06123c39d3518b"),
        "test_logits": "a38e70134a7df8e8",
        "test_logits_fp8": "ec220a26adeea4d6",
    },
    "cnn_to_nested_lstm": {
        "weights": "a43cf4a220c8a060",
        "flops": {(2, True): 67585536, (2, False): 22598144,
                  (20, True): 668837376, (20, False): 223617536},
        "train": (["0x1.5e91e20000000p-1", "0x1.68e8620000000p-1",
                   "0x1.5e01860000000p-1"],
                  "7177d7e2576139e3", "e41bef4f27553264", "8dd951ddd002c485"),
        "train_fp8": (["0x1.60537a0000000p-1"], "a9350feb646c6d8b",
                      "95cd5d1e28eb7c8e", "12609ce7cfc14c9a"),
        "train_half": (["0x1.5f7b940000000p-1", "0x1.67a2d00000000p-1"],
                       "75964d9b4923f347", "2d8eade19cd2a5fd",
                       "6352c108f95ed257"),
    },
}


def digest(tensors):
    h = hashlib.sha256()
    for k in sorted(tensors):
        h.update(k.encode())
        h.update(tensors[k].detach().contiguous().float().numpy().tobytes())
    return h.hexdigest()[:16]


def digest_floats(values):
    return digest({k: torch.tensor(v, dtype=torch.float64)
                   for k, v in values.items()})


def inputs():
    """70 windows of 3 patients (17, 23 and 30 windows), classes 0, 1, 0."""
    raw = torch.randn(70, S, 1, 224,
                      generator=torch.Generator().manual_seed(3))
    cls = torch.tensor([0] * 17 + [1] * 23 + [0] * 30)
    return raw, torch.eye(2)[cls]


def steps_of(step):
    """(steps, masks, dropout rows) of three train steps: batches of 5
    samples, the third with 2 pad rows, or the 3 patients."""
    if step == "samples":
        steps = [list(range(0, 5)), list(range(5, 10)), list(range(10, 15))]
        masks = [np.ones(5, np.float32)] * 2 + [
            np.array([1, 1, 1, 0, 0], np.float32)]
        return steps, masks, [5 * S] * 3
    steps = [list(range(0, 17)), list(range(17, 40)), list(range(40, 70))]
    return (steps, [np.ones(len(s), np.float32) for s in steps],
            [folds.bucket(len(s)) * S for s in steps])


def summary(out):
    return ([float(x).hex() for x in out["losses"]],
            digest(out["first_grad_t"]), digest_floats(out["change"]),
            digest_floats(out["grad_norm"]))


def train(network, weights, n, **kw):
    raw, targets = inputs()
    steps, masks, drawn = steps_of(networks.load(network).STEP)
    return runs.train_steps(network, weights, raw, targets, steps[:n], MU,
                            STD, 21, drawn[:n], HYPER, masks=masks[:n],
                            block=8, **kw)


@pytest.mark.parametrize("network", sorted(PINS))
def test_weights_are_the_pinned_bytes(network):
    w = weights_lib.make_weights(network, S, 11, "cpu")
    assert digest(w) == PINS[network]["weights"]


@pytest.mark.parametrize("network", sorted(PINS))
def test_flops_are_the_pinned_counts(network):
    for (n, training), want in PINS[network]["flops"].items():
        assert flops.flops_per_window(network, n, training) == want


@pytest.mark.parametrize("network,kind", [
    (n, k) for n in sorted(PINS) for k in ("train", "train_fp8",
                                          "train_half")])
def test_train_steps_are_the_pinned_numbers(network, kind):
    w = weights_lib.make_weights(network, S, 11, "cpu")
    n = len(PINS[network][kind][0])
    kw = {"train": {}, "train_fp8": {"quant": fp8_e4m3},
          "train_half": {"leave_out_half": True}}[kind]
    assert summary(train(network, w, n, **kw)) == PINS[network][kind]


@pytest.mark.parametrize("kind", ["test_logits", "test_logits_fp8"])
def test_test_logits_are_the_pinned_numbers(kind):
    network = "cnn_linear"
    w = weights_lib.make_weights(network, S, 11, "cpu")
    raw, targets = inputs()
    ids = np.arange(15).reshape(3, 5)
    masks = np.ones((3, 5), np.float32)
    masks[2, 3:] = 0
    logits, _ = runs.test_logits(
        network, w, raw, targets, list(ids), list(masks), MU, STD, 31,
        5 * S, quant=fp8_e4m3 if kind.endswith("fp8") else None)
    assert digest({"l": torch.cat(logits)}) == PINS[network][kind]


def test_an_unknown_network_names_the_file_looked_for():
    with pytest.raises(ValueError, match=r"networks[/\\]no_such_net\.py"):
        networks.load("no_such_net")


STAND_IN = "bench_test_mean_linear"
STAND_IN_SOURCE = '''
"""A stand-in network: each window's breath features averaged, then a
Linear of 128 -> 2 scaled by a fixed table and shifted by a late draw."""
import torch
import torch.nn.functional as F

from benchmark.reference import model

STEP = "patient"


def scale(shape, generator, device):
    return torch.arange(1, shape[0] + 1, device=device).float()


def late_draw(shape, generator, device):
    return torch.randn(shape, generator=generator, device=device)


def param_spec(n_sub_batches, in_channels=1):
    return (model.backbone_spec(in_channels)
            + model.dense_spec("head", 2, model.n_features())
            + [("scale", (2,), ("custom", scale)),
               ("shift", (2,), ("custom", late_draw))])


def logits(p, feats, quant=None):
    q = quant or model.identity
    out = F.linear(feats.mean(dim=1), q(p["head.weight"]),
                   q(p["head.bias"]))
    return q(out * p["scale"] + p["shift"])
'''


@pytest.fixture
def stand_in(tmp_path, monkeypatch):
    """The stand-in's module, placed where ``networks.load`` searches."""
    (tmp_path / (STAND_IN + ".py")).write_text(
        textwrap.dedent(STAND_IN_SOURCE))
    monkeypatch.setattr(networks, "__path__",
                        list(networks.__path__) + [str(tmp_path)])
    yield STAND_IN
    sys.modules.pop(networks.__name__ + "." + STAND_IN, None)


def test_no_cell_uses_the_stand_in():
    manifest = bench_tiny.harness.read_json(bench_tiny.ROOT,
                                            "BENCHMARK.json")
    flags = [bench_tiny.harness.read_json(bench_tiny.ROOT, c["file"])
             ["flags"]["network"] for c in manifest["configs"]]
    assert STAND_IN not in flags
    assert not os.path.exists(os.path.join(
        os.path.dirname(networks.__file__), STAND_IN + ".py"))


def test_a_stand_in_network_runs_from_its_own_module(stand_in):
    w = weights_lib.make_weights(stand_in, S, 11, "cpu")
    assert torch.equal(w["scale"], torch.tensor([1.0, 2.0]))
    # the late draw follows the normal one: the shared leaves are as a
    # network without it draws them
    nested = weights_lib.make_weights("cnn_to_nested_lstm", S, 11, "cpu")
    assert torch.equal(w["breath_block.conv0.weight"],
                       nested["breath_block.conv0.weight"])
    assert flops.flops_per_window(stand_in, S, True) > flops.flops_per_window(
        stand_in, S, False) > 0
    out = train(stand_in, w, 3)
    assert len(out["losses"]) == 3 and set(out["change"]) == set(w)
    assert all(np.isfinite(out["losses"]))
    assert out["change"]["shift"] > 0 and out["change"][
        "breath_block.conv0.weight"] > 0
    raw, targets = inputs()
    steps, masks, drawn = steps_of("patient")
    logits, losses = runs.test_logits(stand_in, w, raw, targets, steps,
                                      masks, MU, STD, 31, drawn, block=8)
    assert [tuple(x.shape) for x in logits] == [(17, 2), (23, 2), (30, 2)]
    assert len(losses) == 3 and all(np.isfinite(losses))


def test_a_patient_head_gradient_matches_whole_autograd(stand_in):
    """The split at the breath features, backbone in blocks, gives the
    gradient that one autograd graph over the whole patient gives."""
    from benchmark.reference import model

    net = networks.load(stand_in)
    w = weights_lib.make_weights(stand_in, S, 12, "cpu")
    raw, targets = inputs()
    x = raw[:17]
    drop = model.dropout_masks(torch.Generator().manual_seed(5), 32 * S,
                               "cpu")
    keep = torch.ones(17)
    keep[12:] = 0.0
    loss, grads = runs.patient_loss_grads(net, w, x, targets[:17], keep,
                                          drop, block=5)
    leaves = {k: v.detach().requires_grad_() for k, v in w.items()}
    feats = model.features(leaves, x, True, [m[:17 * S] for m in drop])
    whole = model.bce(net.logits(leaves, feats), targets[:17], keep)
    want = torch.autograd.grad(whole, list(leaves.values()))
    assert torch.allclose(loss, whole.detach(), rtol=1e-6)
    for k, g in zip(leaves, want):
        assert torch.allclose(grads[k], g, rtol=1e-4, atol=1e-7), k


def test_a_head_of_its_own_computes_in_blocks(stand_in, monkeypatch):
    """A module's ``loss_grads`` (here the stand-in's loss, window block
    by window block) takes the place of autograd through ``logits``."""
    from benchmark.reference import model

    net = networks.load(stand_in)
    w = weights_lib.make_weights(stand_in, S, 13, "cpu")
    raw, targets = inputs()
    x = raw[17:40]
    drop = model.dropout_masks(torch.Generator().manual_seed(6), 32 * S,
                               "cpu")
    keep = torch.ones(23)
    want_loss, want = runs.patient_loss_grads(net, w, x, targets[17:40],
                                              keep, drop, block=7)

    called = []

    def blocks(p, feats, target, weights, quant=None):
        called.append(feats.shape)
        feats = feats.detach().requires_grad_()
        leaves = {k: v.detach().requires_grad_() for k, v in p.items()}
        total = weights.sum()
        loss = sum(
            model.bce(net.logits(leaves, feats[i:i + 5], quant),
                      target[i:i + 5], weights[i:i + 5])
            * weights[i:i + 5].sum() / total
            for i in range(0, feats.shape[0], 5))
        got = torch.autograd.grad(loss, [feats] + list(leaves.values()))
        return loss.detach(), got[0], dict(zip(leaves, got[1:]))

    monkeypatch.setattr(net, "loss_grads", blocks, raising=False)
    loss, grads = runs.patient_loss_grads(net, w, x, targets[17:40], keep,
                                          drop, block=7)
    assert called == [(23, S, 128)]
    assert torch.allclose(loss, want_loss, rtol=1e-6)
    assert set(grads) == set(want)
    for k in want:
        assert torch.allclose(grads[k], want[k], rtol=1e-4, atol=1e-7), k
