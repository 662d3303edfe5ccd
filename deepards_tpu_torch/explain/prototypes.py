"""Prototype analysis for ProtoPNet.

Counterpart of ``deepards_tpu/explain/prototypes.py`` (reference:
deepards/models/protopnet1d/ppnet_push.py:21-695 PrototypeVisualizer;
protopnet_analysis.py; protopnet_shap.py): each pushed prototype's
receptive field on its source breath, per-window prototype similarities,
a probe of the last layer over them with its top-k prototypes, and
closed-form SHAP values of the linear head.  The visualizer writes the
``.npz`` dumps the JAX package writes where matplotlib is missing, and
the pane its ``.txt`` record; on the CPU host with matplotlib each also
gets the PNG the JAX package draws (``utils/figures.py``; on the card
each PNG stage is refused by name).

The model runs on its device, dropout off, over chunks of ``batch_size``
windows of the dataset's current indices in order (the last chunk short,
unpadded): its norms use each chunk's statistics, so the chunks are the
JAX package's.  Tables are dicts of columns (name -> array) under the JAX
package's column names.
"""
import os
import uuid

import numpy as np
import torch

from deepards_tpu_torch.data.pipeline import gather_pipeline
from deepards_tpu_torch.models.protopnet1d import compute_rf_boundaries
from deepards_tpu_torch.utils import figures


def _device(model):
    return next(model.parameters()).device


@torch.no_grad()
def _forward(model, windows):
    """(logits, minimum distances (B, S*P)) of (B, S, C, L) windows on the
    model's device, dropout off."""
    x = torch.as_tensor(np.asarray(windows, np.float32),
                        device=_device(model))
    return model(x, True)


@torch.no_grad()
def _distance_maps(model, window):
    """(S, L'', P) distance maps of one (S, C, L) window as numpy."""
    x = torch.as_tensor(np.asarray(window, np.float32)[None],
                        device=_device(model))
    return model.push_forward(x, True)[1][0].cpu().numpy()


def draw_prototype(path, breath, lo, hi, title):
    """A breath with a prototype's receptive field shaded
    (prototypes.py:74-85)."""
    plt = figures.pyplot()
    fig, ax = plt.subplots(figsize=(8, 3))
    t = np.arange(len(breath)) * 0.02
    ax.plot(t, breath, "k", lw=1)
    ax.axvspan(lo * 0.02, hi * 0.02, color="orange", alpha=0.4)
    ax.set_title(title)
    ax.set_xlabel("time (s)")
    fig.savefig(path, dpi=120, bbox_inches="tight")
    plt.close(fig)
    return path


def draw_proto_pane(path, breaths, spans):
    """A 4x4 grid of breaths, each with its prototype's receptive field
    shaded (prototypes.py:262-270, 291-313)."""
    plt = figures.pyplot()
    fig, axes = plt.subplots(4, 4, figsize=(20, 10))
    for axis, breath, (lo, hi) in zip(axes.ravel(), breaths, spans):
        axis.plot(np.arange(len(breath)), breath, "k", lw=0.8)
        axis.axvspan(lo, hi, color="orange", alpha=0.4)
        axis.tick_params(axis="x", which="both", bottom=False, top=False,
                         labelbottom=False)
        axis.tick_params(axis="y", labelsize="x-small")
    fig.suptitle("Random Prototype Viz")
    fig.savefig(path, dpi=120)
    plt.close(fig)
    return path


def last_layer_kernel(model):
    """The last layer as the JAX package's (F, 2) kernel."""
    return model.last_layer.weight.detach().cpu().numpy().T


class PrototypeVisualizer:
    """Each pushed prototype's source window with its receptive-field
    span."""

    def __init__(self, model, dataset, results_dir="prototype_results",
                 fname_prefix="proto"):
        self.model = model
        self.dataset = dataset
        self.results_dir = results_dir
        self.fname_prefix = fname_prefix
        self.rf_info = model.proto_layer_rf_info(dataset.seq_len)
        # the prototypes were pushed onto transformed windows
        self.pipeline = gather_pipeline(dataset)

    def viz_prototypes(self, push_info, epoch_num=0):
        """One record a pushed prototype (``push_info`` entries hold
        window_index, flat_pos over the window's S x L'' positions and
        distance; None where no window matched), an ``.npz`` of its
        breath and span and, on the CPU host, its PNG."""
        os.makedirs(self.results_dir, exist_ok=True)
        outputs = []
        s = self.dataset.cache.data.shape[1]
        positions = int(self.rf_info[0])
        for j, info in enumerate(push_info):
            if info is None:
                continue
            widx = info["window_index"]
            window = self.pipeline(self.dataset.cache.data[widx])
            sub, pos = divmod(info["flat_pos"], positions)
            lo, hi = compute_rf_boundaries(pos, self.rf_info,
                                           self.dataset.seq_len)
            breath = window[min(sub, s - 1), 0]
            outputs.append({
                "prototype": j, "window_index": int(widx),
                "sub_batch": int(sub), "rf_lo": lo, "rf_hi": hi,
                "distance": info.get("distance"),
            })
            base = os.path.join(self.results_dir, "{}-epoch{}-p{}".format(
                self.fname_prefix, epoch_num, j))
            np.savez(base + ".npz", breath=breath, rf=(lo, hi))
            title = "prototype {} (window {} sub {})".format(j, widx, sub)
            figures.draw_or_refuse([(base + ".png", lambda path: (
                draw_prototype(path, breath, lo, hi, title)))],
                _device(self.model))
        return outputs


def _chunked_similarities(model, dataset, pipeline, batch_size):
    """Per chunk of the current indices: (chunk, logits, minimum distances
    (B, S*P), their similarities (B, S*P)) as numpy."""
    idxs = dataset.current_indices()
    for start in range(0, len(idxs), batch_size):
        chunk = idxs[start:start + batch_size]
        logits, min_d = _forward(model,
                                 pipeline(dataset.cache.data[chunk]))
        yield (chunk, logits.cpu().numpy(), min_d.cpu().numpy(),
               model.distance_to_similarity(min_d).cpu().numpy())


def prototype_activation_frame(model, dataset, batch_size=16):
    """Per-window prototype similarities, each prototype's mean over the
    window's S sub-sequences: {window_index, prediction, proto_0, ...}."""
    p = model.num_prototypes
    index, preds, sims = [], [], []
    for chunk, logits, _, sim in _chunked_similarities(
            model, dataset, gather_pipeline(dataset), batch_size):
        index.append(chunk)
        preds.append(logits.argmax(axis=1))
        sims.append(sim.reshape(len(chunk), -1, p).mean(axis=1))
    sims = np.concatenate(sims).astype(np.float64) if sims else np.zeros(
        (0, p))
    frame = {"window_index": np.concatenate(index).astype(np.int64),
             "prediction": np.concatenate(preds).astype(np.int64)}
    frame.update(("proto_{}".format(j), sims[:, j]) for j in range(p))
    return frame


class ProtoPNetAnalysis:
    """Prototype-feature probe of the last layer and top-k prototype
    picks (reference: protopnet_analysis.py:26-184).

    The reference's "MLP" trains nothing: it copies the last layer into a
    bias-free identity-activation classifier (protopnet_analysis.py:
    93-110), so the probe is ``softmax(features @ W)`` with W the (F, 2)
    last-layer kernel.  ``train_features``/``test_features`` are (N, F)
    arrays over ``train_gt``/``test_gt``'s rows, columns
    ``feature_names``; ``train_distances``/``test_distances`` the (N, S*P)
    minimum distances they come from."""

    def __init__(self, model, train_dataset, test_dataset, batch_size=16):
        self.model = model
        self.train_ds = train_dataset
        self.test_ds = test_dataset
        # the head was trained on transformed windows
        self.train_pipe = gather_pipeline(train_dataset)
        self.test_pipe = gather_pipeline(test_dataset)
        self.train_gt = train_dataset.get_ground_truth()
        self.test_gt = test_dataset.get_ground_truth()
        self.coefs = last_layer_kernel(model)  # (F, 2)
        self.feature_names = self._make_feature_names()
        self.train_features, self.train_distances = self._gather(
            train_dataset, self.train_pipe, batch_size)
        self.test_features, self.test_distances = self._gather(
            test_dataset, self.test_pipe, batch_size)
        self.train_preds = self.predict_proba(self.train_features)
        self.test_preds = self.predict_proba(self.test_features)

    def _make_feature_names(self):
        """"prototype {breath},{proto}" per last-layer input
        (reference: protopnet_analysis.py:77-91)."""
        p = self.model.num_prototypes
        return ["prototype {},{}".format(i // p, i % p)
                for i in range(self.coefs.shape[0])]

    def _gather(self, dataset, pipeline, batch_size):
        """The last layer's inputs per window, the prototype similarities
        as the head takes them (mean over the S sub-sequences under
        ``average_linear``), and the minimum distances they come from."""
        p = self.model.num_prototypes
        feats, dists = [], []
        for chunk, _, min_d, sims in _chunked_similarities(
                self.model, dataset, pipeline, batch_size):
            if self.model.average_linear:
                sims = sims.reshape(len(chunk), -1, p).mean(axis=1)
            feats.append(sims)
            dists.append(min_d)
        if not feats:
            return (np.zeros((0, self.coefs.shape[0]), np.float32),
                    np.zeros((0, dataset.cache.data.shape[1] * p),
                             np.float32))
        return np.concatenate(feats), np.concatenate(dists)

    def predict_proba(self, features):
        """softmax(features @ W) (reference: protopnet_analysis.py:
        93-110)."""
        logits = np.asarray(features) @ self.coefs
        logits = logits - logits.max(axis=-1, keepdims=True)
        e = np.exp(logits)
        return e / e.sum(axis=-1, keepdims=True)

    def _rf_span_for(self, window, breath_n, proto_n):
        """Receptive-field span of prototype proto_n's best-matching patch
        on breath breath_n of one (S, C, L) window."""
        pos = int(_distance_maps(self.model, window)[breath_n, :,
                                                     proto_n].argmin())
        rf_info = self.model.proto_layer_rf_info(window.shape[-1])
        return compute_rf_boundaries(pos, rf_info, window.shape[-1])

    def plot_random_proto_from_linear_with_topk(self, gt_patho, pred_patho,
                                                topk, rng=None):
        """A random test window of the given truth and prediction, its
        prototype features ranked by their contribution W_jc * feature_j
        to the predicted class, and one of the top ``topk`` drawn:
        returns (window index, breath, prototype)
        (reference: protopnet_analysis.py:122-146)."""
        rng = rng or np.random.default_rng(0)
        gt_n = {"ards": 1, "non_ards": 0}[gt_patho]
        pred_n = {"ards": 1, "non_ards": 0}[pred_patho]
        pred_labels = self.test_preds.argmax(axis=1)
        match = self.test_gt.index[(self.test_gt.y == gt_n)
                                   & (pred_labels == pred_n)]
        if not len(match):
            # a model may never predict one class; fall back to the truth
            # alone, as the JAX package does (the reference would raise)
            match = self.test_gt.index[self.test_gt.y == gt_n]
        if not len(match):
            raise ValueError("no test windows with patho " + gt_patho)
        idx = int(rng.choice(match))
        row = int(np.flatnonzero(self.test_gt.index == idx)[0])
        contrib = self.coefs * self.test_features[row][:, None]  # (F, 2)
        order = np.argsort(contrib[:, pred_n])[::-1][:topk]
        pick = int(rng.choice(order))
        p = self.model.num_prototypes
        breath_n, proto_n = pick // p, pick % p
        window = self.test_pipe(self.test_ds.gather([idx])["data"])[0]
        if self.model.average_linear:
            # the features are per prototype: find its best breath
            proto_n = pick
            maps = _distance_maps(self.model, window)
            breath_n = int(maps[:, :, proto_n].min(axis=1).argmin())
        return idx, min(breath_n, window.shape[0] - 1), proto_n

    def make_random_sequence_pane(self, dirname, rng=None, topk=40):
        """16 random picks, 8 of each class, correctly predicted where
        possible, recorded in ``<dirname>/sample-<uuid4>.txt`` and, on the
        CPU host, drawn with their receptive fields in its ``.png``
        (reference: protopnet_analysis.py:148-173).  Returns the path
        without its extension."""
        rng = rng or np.random.default_rng(0)
        os.makedirs(dirname, exist_ok=True)
        items = 16
        pathos = ["ards"] * (items // 2) + ["non_ards"] * (items // 2)
        rng.shuffle(pathos)
        record, breaths, spans = [], [], []
        for i, p in enumerate(pathos):
            seq_idx, breath_n, proto_n = \
                self.plot_random_proto_from_linear_with_topk(p, p, topk,
                                                             rng=rng)
            record.append([str(i + 1), p, str(seq_idx), str(breath_n),
                           str(proto_n)])
            window = self.test_pipe(self.test_ds.gather([seq_idx])["data"])[0]
            breaths.append(window[breath_n, 0])
            spans.append(self._rf_span_for(window, breath_n, proto_n))
        base = os.path.join(dirname, "sample-{}".format(uuid.uuid4()))
        figures.draw_or_refuse([(base + ".png", lambda path: draw_proto_pane(
            path, breaths, spans))], _device(self.model))
        with open(base + ".txt", "w") as fh:
            fh.write("n, patho, gt_idx, breath_n, proto_n\n")
            for line in record:
                fh.write(", ".join(line) + "\n")
        return base


def prototype_shap_values(model, dataset, batch_size=16):
    """Exact SHAP values of the linear head for the ARDS class over the
    per-prototype mean similarities (reference: protopnet_shap.py:1-77
    ran kernel SHAP): phi_ij = w_j * (sim_ij - E[sim_j]), w_j prototype
    j's weight summed over the window slots.  Returns ({window_index,
    shap_proto_0, ...}, base value).  The closed form needs none of the
    background and sample counts the JAX package's signature carries."""
    frame = prototype_activation_frame(model, dataset, batch_size)
    proto_cols = [c for c in frame if c.startswith("proto_")]
    sims = np.stack([frame[c] for c in proto_cols], axis=1)  # (N, P)
    kernel = last_layer_kernel(model)  # (S*P, 2)
    p = model.num_prototypes
    w = kernel.reshape(kernel.shape[0] // p, p, 2).sum(axis=0)  # (P, 2)
    background = sims.mean(axis=0)
    shap_ards = (sims - background) * w[:, 1][None, :]
    out = {"window_index": frame["window_index"]}
    out.update(("shap_" + c, shap_ards[:, j])
               for j, c in enumerate(proto_cols))
    return out, float(background @ w[:, 1])
