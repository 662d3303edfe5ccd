"""Minimal inference server over a trained checkpoint.

Counterpart of ``deepards_tpu/cli/serve.py``.  Loads the model once onto
the device, warms the forward at a fixed batch shape, and serves:

  GET  /health            -> {"status": "ok", model info}
  POST /predict           -> per-window probabilities + patient votes

Request body: JSON ``{"data": [[..window (S,C,L)..], ...],
"patients": ["a", ...]}`` (patients optional; votes grouped by it) or a
raw .npz upload (array under key "data", optional "patients").

It serves any classifier of the registry; a per-breath head's window
probabilities are the mean of its S windows' softmax, as the JAX server's
are.  A nested (whole-patient) network scores each patient's windows of
the request as one super batch, as its trainer evaluates a patient (all
the windows as one patient when the request names none), zero-padded to
the next power of two with the pad windows masked.  A regressor is not
served: the answer is a softmax, which means nothing for a regressor.
Every dispatch is padded to the warm batch size.  The serving model uses
per-sequence normalization statistics (bn_scope='sequence') so the zero
pad rows cannot change real windows.
Dropout stays active at inference, as in the JAX package, with its
generator reseeded to the same seed at every forward, so the same request
always gets the same answer; a network whose trainer evaluates with
dropout off (cnn_lstm) is served with dropout off, as it is evaluated,
where the JAX server keeps it on.  Input
scaling factors come from --scaling-pickle (a saved ``.npz`` dataset: its
first fold's factors) or else from the checkpoint's .scaling.json
sidecar, unless --allow-unscaled explicitly opts out.

Run: ``python -m deepards_tpu_torch.cli.serve model.pt [--device cuda]``
(``model.pt`` from ``train.checkpoint.save``, or an .npz of the JAX
package's flat params).
"""
import argparse
import io
import json
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

import numpy as np
import torch

from deepards_tpu_torch.device import resolve_device
from deepards_tpu_torch.models.nested import bucket
from deepards_tpu_torch.models.registry import (
    get_base_network,
    get_network_spec,
)
from deepards_tpu_torch.train import checkpoint as ckpt

DROPOUT_SEED = 0


class InferenceEngine:
    """Fixed-shape forward over a checkpoint on one device."""

    def __init__(self, checkpoint, network="cnn_linear",
                 base_network="densenet18", n_sub_batches=20,
                 batch_size=16, scaling=None, bn_scope="sequence",
                 device=None, siamese_time_layer="none"):
        self.device = resolve_device(device)
        # bn_scope='sequence' by default: pad rows of a partial chunk
        # would otherwise share normalization statistics with real
        # windows, and a request would score differently by its size.
        # The parameters do not depend on the scope.
        # the registry's other keys (initial_planes, hidden units) at
        # their defaults, as the JAX server builds its networks
        conf = {"base_network": base_network, "network": network,
                "bn_scope": bn_scope,
                "siamese_time_layer": siamese_time_layer}
        spec = get_network_spec(network)
        if spec.two_dim:
            # requests are windows (S, C, L), as the JAX server's, which
            # has no image path either
            raise ValueError(
                "{} is a 2D network: the server answers requests of "
                "breath windows, not images".format(network))
        if spec.kind != "classifier":
            raise ValueError(
                "{} is a {}: the server answers with class probabilities, "
                "a softmax that means nothing for it".format(
                    network, spec.kind))
        self.deterministic = spec.eval_dropout_off
        self.super_batch = spec.super_batch
        model = spec.build(conf, get_base_network(conf), n_sub_batches)
        model.load_state_dict(ckpt.restore(checkpoint)["params"])
        self.model = model.to(self.device)
        self.batch_size = batch_size
        self.n_sub_batches = n_sub_batches
        self.network = network
        self.bn_scope = bn_scope
        self.scaling = scaling  # (mu, std) or None
        if scaling:
            mu = torch.as_tensor(np.asarray(scaling[0], np.float32).ravel())
            std = torch.as_tensor(np.asarray(scaling[1], np.float32).ravel())
            # broadcast over (N, S, C, L): scalar or per-channel factors
            if mu.numel() > 1:
                mu = mu.reshape(1, 1, -1, 1)
                std = std.reshape(1, 1, -1, 1)
            self._mu, self._std = mu.to(self.device), std.to(self.device)
        else:
            self._mu, self._std = 0.0, 1.0
        self._generator = torch.Generator(device=self.device)
        self._lock = threading.Lock()

    @torch.inference_mode()
    def _forward(self, data, **kwargs):
        x = (data - self._mu) / self._std
        self._generator.manual_seed(DROPOUT_SEED)
        out = self.model(x, self.deterministic, self._generator, **kwargs)
        if isinstance(out, tuple):
            out = out[0]  # a stateful head's (logits, carry)
        probs = torch.softmax(out, dim=-1)
        if probs.ndim == 3 and not self.super_batch:
            probs = probs.mean(dim=1)  # a per-breath head: its windows' mean
        return probs

    def warm(self, channels=1, length=224):
        x = torch.zeros(
            (self.batch_size, self.n_sub_batches, channels, length),
            device=self.device,
        )
        with self._lock:
            self._forward(x)
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def predict(self, data, patients=None):
        """data: (N, S, C, L) -> (N, 2) probabilities, dispatched in
        chunks padded to the warm batch size (a nested network: one
        super batch a patient of ``patients``)."""
        data = np.asarray(data, np.float32)
        if data.ndim == 3:
            data = data[None]
        if self.super_batch:
            return self._predict_patients(data, patients)
        n = data.shape[0]
        probs = []
        with self._lock:  # one device queue and one dropout generator
            for lo in range(0, n, self.batch_size):
                chunk = data[lo:lo + self.batch_size]
                real = len(chunk)
                pad = self.batch_size - real
                if pad:
                    chunk = np.concatenate([
                        chunk,
                        np.zeros((pad,) + chunk.shape[1:], chunk.dtype),
                    ])
                x = torch.from_numpy(chunk).to(self.device)
                probs.append(self._forward(x)[:real].cpu().numpy())
        return np.concatenate(probs)

    def _predict_patients(self, data, patients):
        """Each patient's windows (in request order) as one (1, W, S, C, L)
        super batch padded to a power of two, the pad windows masked."""
        n = data.shape[0]
        patients = np.asarray([""] * n if patients is None
                              else [str(p) for p in patients])
        probs = np.zeros((n, 2), np.float32)
        with self._lock:
            for patient in dict.fromkeys(patients.tolist()):
                rows = np.flatnonzero(patients == patient)
                w = len(rows)
                x = np.zeros((1, bucket(w)) + data.shape[1:], np.float32)
                x[0, :w] = data[rows]
                mask = torch.zeros(1, x.shape[1], dtype=torch.bool,
                                   device=self.device)
                mask[0, :w] = True
                out = self._forward(torch.from_numpy(x).to(self.device),
                                    window_mask=mask)
                probs[rows] = out[0, :w].cpu().numpy()
        return probs


def patient_votes(probs, patients):
    """Per-patient ARDS vote fraction + majority prediction."""
    votes = {}
    for p, pr in zip(patients, probs):
        votes.setdefault(str(p), []).append(int(pr.argmax()))
    return {
        p: {
            "pred_frac": float(np.mean(v)),
            "prediction": int(np.mean(v) >= 0.5),
            "n_windows": len(v),
        }
        for p, v in votes.items()
    }


def make_handler(engine):
    class Handler(BaseHTTPRequestHandler):
        def log_message(self, *args):
            pass  # quiet; the caller owns logging

        def _send(self, code, payload):
            body = json.dumps(payload).encode()
            self.send_response(code)
            self.send_header("Content-Type", "application/json")
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def do_GET(self):
            if self.path == "/health":
                self._send(200, {
                    "status": "ok",
                    "network": engine.network,
                    "n_sub_batches": engine.n_sub_batches,
                    "batch_size": engine.batch_size,
                    "bn_scope": engine.bn_scope,
                    "scaled": engine.scaling is not None,
                    "device": str(engine.device),
                })
            else:
                self._send(404, {"error": "unknown path"})

        def do_POST(self):
            if self.path != "/predict":
                self._send(404, {"error": "unknown path"})
                return
            length = int(self.headers.get("Content-Length", 0))
            raw = self.rfile.read(length)
            try:
                ctype = self.headers.get("Content-Type", "")
                if "json" in ctype:
                    req = json.loads(raw)
                    data = np.asarray(req["data"], np.float32)
                    patients = req.get("patients")
                else:
                    z = np.load(io.BytesIO(raw), allow_pickle=False)
                    data = np.asarray(z["data"], np.float32)
                    patients = (
                        [str(p) for p in z["patients"]]
                        if "patients" in z else None
                    )
                probs = engine.predict(data, patients)
                resp = {
                    "prob_other": probs[:, 0].tolist(),
                    "prob_ards": probs[:, 1].tolist(),
                    "predictions": probs.argmax(axis=1).tolist(),
                }
                if patients is not None:
                    resp["patient_votes"] = patient_votes(probs, patients)
                self._send(200, resp)
            except Exception as exc:  # surface the error to the client
                self._send(400, {
                    "error": "{}: {}".format(type(exc).__name__, exc),
                })

    return Handler


def serve(engine, host="127.0.0.1", port=8476):
    return ThreadingHTTPServer((host, port), make_handler(engine))


def load_serving_scaling(checkpoint, scaling_pickle=None):
    """(mu, std) for serving: the first fold's factors of a saved dataset
    when one is given, else the checkpoint's sidecar (None if neither)."""
    if scaling_pickle:
        from deepards_tpu_torch.data.dataset import ARDSRawDataset

        factors = ARDSRawDataset.from_pickle(scaling_pickle).scaling_factors
        if factors:
            mu, std = next(iter(factors.values()))
            return np.asarray(mu), np.asarray(std)
    return ckpt.load_scaling(checkpoint)


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__)
    parser.add_argument("checkpoint")
    parser.add_argument("--network", default="cnn_linear")
    parser.add_argument("--base-network", default="densenet18")
    parser.add_argument("--n-sub-batches", type=int, default=20)
    parser.add_argument("--siamese-time-layer", default="none",
                        choices=("none", "lstm", "transformer"),
                        help="siamese_pretrained's time layer")
    parser.add_argument("--batch-size", type=int, default=16)
    parser.add_argument("--host", default="127.0.0.1")
    parser.add_argument("--port", type=int, default=8476)
    parser.add_argument("--scaling-pickle",
                        help="saved .npz dataset whose train scaling "
                        "factors normalize incoming windows")
    parser.add_argument("--device", default="cuda",
                        help="torch device to serve on (default: cuda)")
    parser.add_argument("--bn-scope", default="sequence",
                        choices=("sequence", "batch"),
                        help="normalization scope for serving; 'sequence' "
                        "(default) is pad-immune, 'batch' reproduces "
                        "training-time whole-batch statistics but lets "
                        "pad rows contaminate partial chunks")
    parser.add_argument("--allow-unscaled", action="store_true",
                        help="serve without input scaling factors "
                        "(predictions from a pipeline-trained checkpoint "
                        "will be WRONG; for debugging only)")
    args = parser.parse_args(argv)

    scaling = load_serving_scaling(args.checkpoint, args.scaling_pickle)
    if scaling is None:
        msg = ("no scaling factors: pass --scaling-pickle or use a "
               "checkpoint with a .scaling.json sidecar; a checkpoint "
               "trained through the normalization pipeline will serve "
               "mis-scaled (wrong) predictions without them")
        if not args.allow_unscaled:
            parser.error(msg)
        print("WARNING: {} (continuing: --allow-unscaled)".format(msg))

    engine = InferenceEngine(
        args.checkpoint, network=args.network,
        base_network=args.base_network,
        n_sub_batches=args.n_sub_batches, batch_size=args.batch_size,
        scaling=scaling, bn_scope=args.bn_scope, device=args.device,
        siamese_time_layer=args.siamese_time_layer,
    )
    engine.warm()
    server = serve(engine, args.host, args.port)
    print("serving {} on http://{}:{} ({})".format(
        args.network, args.host, args.port, engine.device))
    server.serve_forever()
    return engine


if __name__ == "__main__":
    main()
