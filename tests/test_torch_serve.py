"""The slice as a whole on the CPU: the port's server against the JAX one.

The JAX side is the forward of ``deepards_tpu/cli/serve.py`` (scale by
(mu, std), pad each chunk to the batch size, apply, softmax), with dropout
off; the port's ``InferenceEngine`` gets the same flax parameters through
``transplant``, the same scaling and its dropout off too.  Full width:
cnn_linear over densenet18 (F = 128), windows (S = 20, C = 1, L = 224),
37 windows in chunks of 16 (the last one padded).  Probabilities agree to
atol 1e-4 and patient votes exactly.
"""
import io
import json
import threading
import urllib.error
import urllib.request

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import traverse_util

from deepards_tpu.models import densenet1d as jdn
from deepards_tpu.models import heads as jheads
from deepards_tpu_torch.cli import serve as tserve
from deepards_tpu_torch.models.densenet1d import DenseLayer
from deepards_tpu_torch.train import checkpoint as ckpt
from deepards_tpu_torch.transplant import transplant

# parallel test workers share the cores: one torch thread each
torch.set_num_threads(1)

S, C, L = 20, 1, 224
BATCH = 16
N_WINDOWS = 37


@pytest.fixture(scope="module")
def windows():
    rng = np.random.default_rng(21)
    return (rng.normal(size=(N_WINDOWS, S, C, L)) * 20 + 3).astype(
        np.float32)


@pytest.fixture(scope="module")
def flax_params():
    model = jheads.CNNLinearNetwork(breath_block=jdn.densenet18(drop_rate=0.0))
    x = jnp.zeros((BATCH, S, C, L), jnp.float32)
    params = model.init(jax.random.PRNGKey(5), x, None, True)["params"]
    return jax.tree_util.tree_map(np.asarray, params)


@pytest.fixture(scope="module")
def checkpoint(tmp_path_factory, flax_params, windows):
    path = str(tmp_path_factory.mktemp("serve") / "model.pt")
    return ckpt.save(path, transplant(flax_params),
                     scaling=(windows.mean(), windows.std()))


def _engine(checkpoint, bn_scope="sequence"):
    engine = tserve.InferenceEngine(
        checkpoint, scaling=ckpt.load_scaling(checkpoint), bn_scope=bn_scope,
        device="cpu")
    return engine


def _dropout_off(engine):
    for mod in engine.model.modules():
        if isinstance(mod, DenseLayer):
            mod.drop_rate = 0.0


def _jax_serve_probs(params, data, mu, std, bn_scope):
    """deepards_tpu/cli/serve.py's forward and padded chunking, with
    dropout off."""
    model = jheads.CNNLinearNetwork(
        breath_block=jdn.densenet18(drop_rate=0.0), bn_scope=bn_scope)

    @jax.jit
    def forward(x):
        out = model.apply({"params": params}, (x - mu) / std, None, True)
        return jax.nn.softmax(out, axis=-1)

    probs = []
    for lo in range(0, len(data), BATCH):
        chunk = data[lo:lo + BATCH]
        pad = BATCH - len(chunk)
        if pad:
            chunk = np.concatenate(
                [chunk, np.zeros((pad,) + chunk.shape[1:], chunk.dtype)])
        probs.append(np.asarray(forward(jnp.asarray(chunk)))[:BATCH - pad])
    return np.concatenate(probs)


@pytest.mark.parametrize("bn_scope", ["sequence", "batch"])
def test_served_probabilities_match_jax(checkpoint, flax_params, windows,
                                        bn_scope):
    engine = _engine(checkpoint, bn_scope)
    _dropout_off(engine)
    got = engine.predict(windows)
    mu, std = ckpt.load_scaling(checkpoint)
    want = _jax_serve_probs(flax_params, windows, mu, std, bn_scope)
    assert got.shape == (N_WINDOWS, 2)
    np.testing.assert_allclose(got, want, atol=1e-4, rtol=0)
    patients = ["pt{}".format(i % 4) for i in range(N_WINDOWS)]
    assert tserve.patient_votes(got, patients) == tserve.patient_votes(
        want, patients)


def test_dropout_active_but_repeatable(checkpoint, windows):
    """Dropout stays on at inference, reseeded at every forward: the same
    request gets the same answer, and differs from dropout off."""
    engine = _engine(checkpoint)
    first = engine.predict(windows[:5])
    assert np.array_equal(first, engine.predict(windows[:5]))
    _dropout_off(engine)
    assert not np.allclose(first, engine.predict(windows[:5]), atol=1e-6)


def test_sequence_scope_is_pad_immune(checkpoint, windows):
    engine = _engine(checkpoint)
    alone = engine.predict(windows[:3])
    in_full_chunk = engine.predict(windows[:BATCH])[:3]
    np.testing.assert_allclose(alone, in_full_chunk, atol=1e-6, rtol=0)


def test_checkpoint_and_scaling_round_trip(tmp_path, flax_params):
    state = transplant(flax_params)
    path = ckpt.save(str(tmp_path / "m.pt"), state,
                     scaling=(np.float32(1.5), np.float32(2.0)))
    restored = ckpt.restore(path)["params"]
    assert restored.keys() == state.keys()
    for k in state:
        assert torch.equal(restored[k], state[k])
    mu, std = ckpt.load_scaling(path)
    assert mu.tolist() == [1.5] and std.tolist() == [2.0]
    assert ckpt.load_scaling(str(tmp_path / "none.pt")) is None
    # the JAX package's flat params saved with np.savez restore as well
    npz = str(tmp_path / "flax_params.npz")
    np.savez(npz, **traverse_util.flatten_dict(flax_params, sep="/"))
    from_npz = ckpt.restore(npz)["params"]
    for k in state:
        assert torch.equal(from_npz[k], state[k])


def test_http_round_trip_on_loopback(checkpoint, windows):
    engine = _engine(checkpoint)
    engine.warm()
    server = tserve.serve(engine, "127.0.0.1", 0)
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    base = "http://127.0.0.1:{}".format(server.server_address[1])

    def post(body, ctype, path="/predict"):
        req = urllib.request.Request(base + path, data=body,
                                     headers={"Content-Type": ctype})
        with urllib.request.urlopen(req, timeout=60) as resp:
            return json.loads(resp.read())

    try:
        with urllib.request.urlopen(base + "/health", timeout=60) as resp:
            health = json.loads(resp.read())
        by_json = post(json.dumps({"data": windows[:2].tolist(),
                                   "patients": ["a", "b"]}).encode(),
                       "application/json")
        buf = io.BytesIO()
        np.savez(buf, data=windows[:2], patients=np.array(["a", "b"]))
        by_npz = post(buf.getvalue(), "application/octet-stream")
        with pytest.raises(urllib.error.HTTPError) as bad:
            post(b"not an npz", "application/octet-stream")
        assert bad.value.code == 400
        bad.value.close()
    finally:
        server.shutdown()
        server.server_close()
        thread.join(timeout=30)
    assert not thread.is_alive()
    assert health["status"] == "ok" and health["scaled"]
    assert health["device"] == "cpu" and health["bn_scope"] == "sequence"
    want = engine.predict(windows[:2])
    np.testing.assert_allclose(by_json["prob_ards"], want[:, 1], atol=1e-6)
    np.testing.assert_allclose(by_npz["prob_ards"], want[:, 1], atol=1e-6)
    assert by_json["predictions"] == want.argmax(axis=1).tolist()
    assert by_json["patient_votes"] == tserve.patient_votes(want, ["a", "b"])
    assert by_npz["patient_votes"] == by_json["patient_votes"]


def test_main_requires_scaling(tmp_path, flax_params):
    path = ckpt.save(str(tmp_path / "unscaled.pt"), transplant(flax_params))
    with pytest.raises(SystemExit):
        tserve.main([path, "--device", "cpu"])
