"""Per-patient GradCAM operations.

Counterpart of ``deepards_tpu/explain/patient_gradcam.py`` (reference:
deepards/patient_gradcam.py:30-437): for each patient of a dataset's
current indices, cams over median or average breaths, sampled sequences,
full reads, per-hour samples, random stratified panes, or DTW clustering
of cam-active spans, saved under ``<results_dir>/<op>/<patho>/``.  Each op
writes the ``.npz`` dumps the JAX package writes where matplotlib is
missing (``cam_by_hour`` its payloads with ``pickle``, ``rand_sample`` its
``.txt`` records too) and, on the CPU host with matplotlib, the PNGs the
JAX package draws in their place (``utils/figures.py``; on the card each
PNG stage is refused by name).

Patients run in order of first appearance in the truth and their windows
in its order, so a seeded generator picks the windows the JAX package
picks.  Multi-sequence ops batch their cams through one device pass per
chunk.  ``dtw_clust`` uploads the zero-padded spans once, gathers each
chunk's pairs on the device and scores them with ``ops.dtw.dtw_batch``
(the CUDA kernel on a card), reading the distances back once.
"""
import contextlib
import functools
import os
import pickle
import time
import uuid

import numpy as np
import torch

from deepards_tpu_torch.data.pipeline import gather_pipeline
from deepards_tpu_torch.dtw.kmedoids import KMedoids
from deepards_tpu_torch.explain.gradcam import MaxMinNormCam, upsample_cam
from deepards_tpu_torch.ops.dtw import dtw_batch
from deepards_tpu_torch.utils import figures

PATHO_NAME = {0: "non_ards", 1: "ards"}


def draw_cam(path, breath, cam224, title):
    """A breath with its cam behind it (patient_gradcam.py:89-104)."""
    plt = figures.pyplot()
    fig, ax = plt.subplots(figsize=(8, 3))
    t = np.arange(len(breath)) * 0.02
    ax.plot(t, breath, "k", lw=1)
    ax.imshow(cam224[None, :], aspect="auto", cmap="jet", alpha=0.4,
              extent=[t[0], t[-1], min(breath), max(breath)])
    ax.set_xlabel("time (s)")
    ax.set_ylabel("flow (l/min)")
    ax.set_title(title)
    fig.savefig(path, dpi=120, bbox_inches="tight")
    plt.close(fig)
    return path


def draw_pane(path, breaths, cams, patho):
    """A square grid of breaths coloured by their upsampled cams
    (patient_gradcam.py:285-306)."""
    plt = figures.pyplot()
    side = int(np.sqrt(len(breaths)))
    fig, axes = plt.subplots(side, side, figsize=(20, 10))
    for k, ax in enumerate(axes.ravel()):
        br = breaths[k, 0]
        t = np.arange(len(br))
        ax.scatter(t, br, c=upsample_cam(cams[k]), vmin=0, vmax=255, s=4)
        ax.plot(t, br, lw=0.5)
        ax.tick_params(axis="x", which="both", bottom=False, top=False,
                       labelbottom=False)
        ax.tick_params(axis="y", labelsize="x-small")
    title = {"random": "Random", "non_ards": "Non-ARDS",
             "ards": "ARDS"}[patho]
    fig.suptitle("{} Grad-Cam".format(title))
    fig.subplots_adjust(right=0.8)
    cbar_ax = fig.add_axes((0.85, 0.15, 0.025, 0.7))
    sm = plt.cm.ScalarMappable(norm=plt.Normalize(vmin=0, vmax=255))
    fig.colorbar(sm, cax=cbar_ax).set_label("Intensity")
    fig.savefig(path, dpi=120)
    plt.close(fig)
    return path


def draw_elbow(path, ks, distortions, title):
    """Mean distance to the medoid by cluster count
    (patient_gradcam.py:438-448)."""
    plt = figures.pyplot()
    fig, ax = plt.subplots()
    ax.plot(ks, distortions)
    ax.set_xlabel("n clusters")
    ax.set_ylabel("mean distance to medoid")
    ax.set_title(title)
    fig.savefig(path, dpi=120)
    plt.close(fig)
    return path


def draw_grads(path, ards, other):
    """Histograms of the cam gradients' norms by predicted class
    (patient_gradcam.py:477-485)."""
    plt = figures.pyplot()
    fig, ax = plt.subplots()
    ax.hist(ards, bins=20, label="ARDS", alpha=0.5)
    ax.hist(other, bins=20, label="Other", alpha=0.5)
    ax.legend()
    fig.savefig(path, dpi=120)
    plt.close(fig)
    return path


class StageTimer:
    """Times of ``do_dtw_clust`` for a caller that passes one: host seconds
    by stage, summed over patients and targets, with the device
    synchronised at both ends of each (``seconds``), and on a card the
    milliseconds between CUDA events around each DTW chunk's gather and
    ``dtw_batch`` call (``device_ms``: lists by name).  The events hold
    the calls' host time too where it is longer than their kernels; the
    kernel's own time needs a profiler."""

    def __init__(self):
        self.seconds = {}
        self._events = {}

    @staticmethod
    def _synchronize(device):
        if device.type == "cuda":
            torch.cuda.synchronize(device)

    @contextlib.contextmanager
    def stage(self, name, device):
        self._synchronize(device)
        t0 = time.perf_counter()
        yield
        self._synchronize(device)
        self.seconds[name] = (self.seconds.get(name, 0.0)
                              + time.perf_counter() - t0)

    def on_device(self, name, device, fn):
        """``fn()``, between two CUDA events on a card."""
        if device.type != "cuda":
            return fn()
        start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        start.record()
        out = fn()
        end.record()
        self._events.setdefault(name, []).append((start, end))
        return out

    @property
    def device_ms(self):
        return {name: [start.elapsed_time(end) for start, end in pairs]
                for name, pairs in self._events.items()}


class PatientGradCam:
    """Cam operations over ``dataset``'s current windows for ``model`` (a
    cnn_linear-family network on its device).  ``timer``: a
    ``StageTimer`` that records ``do_dtw_clust``'s stages."""

    def __init__(self, model, dataset, results_dir="gradcam_results",
                 cam_cls=MaxMinNormCam, target="ground_truth", timer=None):
        self.cam = cam_cls(model)
        self.dataset = dataset
        self.results_dir = results_dir
        self.gt = dataset.get_ground_truth()
        self.target = target
        self.timer = timer
        # gather returns raw rows; the model was trained on the fold's
        # transformed ones
        self.pipeline = gather_pipeline(dataset)

    def get_target(self, ground_truth):
        """Cam target class list for one patient
        (reference: patient_gradcam.py:46-54)."""
        if isinstance(self.target, int):
            return [self.target]
        if self.target == "ground_truth":
            return [int(ground_truth)]
        if self.target == "both":
            return [0, 1]
        return [{"ards": 1, "other": 0}[self.target]]

    def _patient_rows(self, patient_id):
        return self.gt.select(self.gt.patient == patient_id)

    def _patho_name(self, patient_id):
        return PATHO_NAME[int(self._patient_rows(patient_id).y[0])]

    def _stage(self, name):
        if self.timer is None:
            return contextlib.nullcontext()
        return self.timer.stage(name, self.cam.device)

    def _on_device(self, name, fn):
        if self.timer is None:
            return fn()
        return self.timer.on_device(name, self.cam.device, fn)

    def _save(self, op, patient_id, breath, cam, suffix="", subdir=None):
        out_dir = os.path.join(self.results_dir, op,
                               self._patho_name(patient_id))
        if subdir:
            out_dir = os.path.join(out_dir, subdir)
        os.makedirs(out_dir, exist_ok=True)
        base = os.path.join(out_dir, "{}{}".format(patient_id, suffix))
        cam224 = upsample_cam(cam)
        np.savez(base + ".npz", breath=breath, cam=cam224)
        figures.draw_or_refuse([(base + ".png", lambda path: draw_cam(
            path, breath, cam224, "{} {}".format(patient_id, op)))],
            self.cam.device)

    def _gather(self, idx):
        """Gathered rows with the fold's transforms applied."""
        batch = dict(self.dataset.gather(np.asarray(idx)))
        batch["data"] = self.pipeline(batch["data"])
        return batch

    def _patient_data(self, patient_id):
        return self._gather(self._patient_rows(patient_id).index)

    # -- batched cam helpers -------------------------------------------------

    def _read_cams_batch(self, windows, targets, chunk=64):
        """Per-breath cams of many (S, C, L) windows, ``chunk`` windows a
        device pass."""
        cams, outs = [], []
        for lo in range(0, len(windows), chunk):
            c, o = self.cam.generate_read_cams_batch(
                windows[lo:lo + chunk], targets[lo:lo + chunk])
            cams.append(c)
            outs.append(o)
        return np.concatenate(cams), np.concatenate(outs)

    def _single_seq_cams_batch(self, breaths, targets):
        """Single-sequence cams: each (C, L) breath repeated S times (the
        reference's batch-repeat trick, patient_gradcam.py:208-218), all
        in batched passes.  Returns (B, L') cams and (B, 1, 2) outputs, a
        one-sequence output per breath as the reference's."""
        s = self.dataset.n_sub_batches
        xs = np.repeat(np.asarray(breaths)[:, None], s, axis=1)
        cams, outs = self._read_cams_batch(xs, np.asarray(targets))
        # the rows are identical: row 0 is the cam of the repeated batch
        return cams[:, 0, :], outs[:, None]

    # -- the reference's ops -------------------------------------------------

    def do_medians(self):
        """Median breath per patient -> cam
        (reference: patient_gradcam.py:56-82)."""
        self._center_cams("medians", np.median)

    def do_averages(self):
        """(reference: patient_gradcam.py:84-115)"""
        self._center_cams("averages", np.mean)

    def _center_cams(self, op, center):
        for pt in self.gt.patients():
            data = self._patient_data(pt)["data"]
            breath = center(data.reshape(-1, *data.shape[-2:]), axis=0)
            read = np.repeat(breath[None], self.dataset.n_sub_batches, axis=0)
            target = self.get_target(self._patient_rows(pt).y[0])[0]
            cam, _ = self.cam.generate_cam(read, target)
            self._save(op, pt, breath[0], cam)

    def do_sample_sequences(self, n=2, rng=None):
        """(reference: patient_gradcam.py:117-136)"""
        rng = rng or np.random.default_rng(0)
        for pt in self.gt.patients():
            rows = self._patient_rows(pt)
            pick = rng.choice(rows.index, size=min(n, len(rows.index)),
                              replace=False)
            for target in self.get_target(rows.y[0]):
                for i, idx in enumerate(pick):
                    window = self._gather([idx])["data"][0]
                    cam, _ = self.cam.generate_cam(window, target)
                    breath = window.reshape(-1)[:window.shape[-1]]
                    self._save("sample_seqs", pt, breath, cam,
                               suffix="-{}-t{}".format(i, target))

    def do_read_cam(self, rng=None):
        """The cams of a whole read, one a breath, of the first 3 breaths
        saved (reference: patient_gradcam.py:160-173)."""
        rng = rng or np.random.default_rng(0)
        for pt in self.gt.patients():
            rows = self._patient_rows(pt)
            idx = int(rng.choice(rows.index))
            window = self._gather([idx])["data"][0]
            target = self.get_target(rows.y[0])[0]
            cams, _ = self.cam.generate_read_cam(window, target)
            for b in range(min(3, cams.shape[0])):
                self._save("read_cam", pt, window[b, 0], cams[b],
                           suffix="-b{}".format(b))

    def do_cam_by_hour(self, hour_start=0, hour_end=24,
                       n_sequences_per_hour=None, rng=None):
        """Per-hour cams: every breath of every (sampled) window in the
        hour band gets a single-sequence cam, its payload (breath,
        upsampled cam, model output, ids) pickled for later rendering
        (reference: patient_gradcam.py:138-159).  The files and keys are
        the JAX package's, which writes them with ``pd.to_pickle``."""
        rng = rng or np.random.default_rng(0)
        s = self.dataset.n_sub_batches
        for pt in self.gt.patients():
            rows = self._patient_rows(pt)
            idxs = rows.index[(rows.hour >= hour_start)
                              & (rows.hour < hour_end)]
            if not len(idxs):
                continue
            if n_sequences_per_hour is not None:
                take = min(n_sequences_per_hour, len(idxs))
                idxs = rng.choice(idxs, size=take, replace=False)
            data = self._gather(idxs)["data"]  # (B, S, C, L)
            for target in self.get_target(rows.y[0]):
                breaths = data.reshape(-1, *data.shape[2:])
                cams, outs = self._single_seq_cams_batch(
                    breaths, np.full(len(breaths), target))
                out_dir = os.path.join(
                    self.results_dir, "hour_sequences", PATHO_NAME[target],
                    str(pt), str(hour_start))
                os.makedirs(out_dir, exist_ok=True)
                for k, abs_idx in enumerate(np.repeat(idxs, s)):
                    payload = {
                        "breath": breaths[k, 0],
                        "cam": upsample_cam(cams[k]),
                        "model_output": outs[k],
                        "patient": str(pt),
                        "abs_idx": int(abs_idx),
                        "seq_idx": int(k % s),
                        "target": int(target),
                    }
                    name = "seq-{}-{}-target-{}.pkl".format(
                        abs_idx, k % s, self.target)
                    with open(os.path.join(out_dir, name), "wb") as f:
                        pickle.dump(payload, f)

    # -- rand_sample panes ---------------------------------------------------

    def _pane(self, patho, dirname, rng, items_per_frame=16):
        """One pane of random single-sequence cams: an ``.npz`` of its
        breaths and cams and its ``.txt`` record, named by a uuid4
        (reference: patient_gradcam.py:264-291)."""
        if patho == "random":
            patho_iter = (["ards"] * (items_per_frame // 2)
                          + ["non_ards"] * (items_per_frame // 2))
            rng.shuffle(patho_iter)
        else:
            patho_iter = [patho] * items_per_frame

        picks = []  # (abs_idx, breath_idx, target)
        for p in patho_iter:
            target = {"ards": 1, "non_ards": 0}[p]
            abs_idx = int(rng.choice(self.gt.index[self.gt.y == target]))
            br_idx = int(rng.integers(0, self.dataset.n_sub_batches))
            picks.append((abs_idx, br_idx, target))

        windows = self._gather([p[0] for p in picks])["data"]
        breaths = np.stack([windows[i, b]
                            for i, (_, b, _) in enumerate(picks)])
        cams, _ = self._single_seq_cams_batch(
            breaths, np.asarray([t for _, _, t in picks]))
        base = os.path.join(dirname, "{}-sample-{}".format(patho,
                                                           uuid.uuid4()))
        np.savez(base + ".npz", breaths=breaths, cams=cams)
        figures.draw_or_refuse([(base + ".png", lambda path: draw_pane(
            path, breaths, cams, patho))], self.cam.device)
        with open(base + ".txt", "w") as record:
            record.write("n, patho, sequence_idx, breath_idx\n")
            for k, (abs_idx, br_idx, target) in enumerate(picks):
                record.write("{}, {}, {}, {}\n".format(
                    k + 1, PATHO_NAME[target], abs_idx, br_idx))

    def do_rand_sample(self, randomize_groups=False, rng=None,
                       panes_per_group=3):
        """Random stratified panes of one pathophysiology each, or of
        shuffled groups (reference: patient_gradcam.py:293-306)."""
        rng = rng or np.random.default_rng(0)
        kind = "randomized" if randomize_groups else "non_random"
        dirname = os.path.join(self.results_dir, "rand_sample", kind)
        os.makedirs(dirname, exist_ok=True)
        groups = (["random"] * 2 if randomize_groups
                  else ["ards", "non_ards"])
        for patho in groups:
            for _ in range(panes_per_group):
                self._pane(patho, dirname, rng)

    # -- dtw_clust -----------------------------------------------------------

    def _cam_active_spans(self, cams224, breaths, sequence_thresh=0.8,
                          seq_min_len=5):
        """Waveform spans where the upsampled cam stays at or above
        sequence_thresh * 255 for at least seq_min_len samples
        (reference: patient_gradcam.py:328-340).  The reference slices
        ``br[.., group_id:group_id+length-1]``, the group counter and not
        the run's start sample; this slices the run itself, the
        documented intent, as the JAX package does."""
        spans = []
        thresh = sequence_thresh * 255.0
        for row_cam, row_br in zip(cams224, breaths):
            active = np.asarray(row_cam, np.float64) >= thresh
            if not active.any():
                continue
            padded = np.concatenate([[False], active, [False]])
            edges = np.flatnonzero(np.diff(padded.astype(np.int8)))
            for s, e in zip(edges[::2], edges[1::2]):
                if e - s >= seq_min_len:
                    spans.append(np.asarray(row_br[s:e], np.float32))
        return spans

    def _pairwise_dtw_matrix(self, sequences, chunk=4096):
        """Symmetric float64 DTW matrix of variable-length spans, zero on
        the diagonal: the spans zero-padded to the longest and uploaded
        once, each chunk of ``np.triu_indices`` pairs gathered on the
        device and scored by ``dtw_batch`` there, the distances read back
        once (the reference runs N^2/2 sequential C calls,
        patient_gradcam.py:342-348)."""
        n = len(sequences)
        D = np.zeros((n, n), np.float64)
        if n < 2:
            return D
        device = self.cam.device
        with self._stage("upload"):
            lens = np.fromiter((len(s) for s in sequences), np.int32,
                               count=n)
            padded = np.zeros((n, lens.max()), np.float32)
            for i, s in enumerate(sequences):
                padded[i, :lens[i]] = s
            ii, jj = np.triu_indices(n, k=1)
            spans, span_lens, ii_d, jj_d = (
                torch.from_numpy(x).to(device)
                for x in (padded, lens, ii, jj))
        with self._stage("dtw"):
            dist = torch.empty(len(ii), dtype=torch.float32, device=device)
            for lo in range(0, len(ii), chunk):
                a_idx, b_idx = ii_d[lo:lo + chunk], jj_d[lo:lo + chunk]
                a, b, la, lb = self._on_device("gather", lambda: (
                    spans[a_idx], spans[b_idx], span_lens[a_idx],
                    span_lens[b_idx]))
                dist[lo:lo + chunk] = self._on_device(
                    "kernel", lambda: dtw_batch(a, b, la, lb, device=device))
        with self._stage("assembly"):
            d = dist.cpu().numpy()
            D[ii, jj] = d
            D[jj, ii] = d
        return D

    def do_dtw_clust(self, sequence_thresh=0.8, seq_min_len=5,
                     max_clusters=20):
        """Cam-active spans -> DTW matrix -> KMedoids elbow per patient and
        target (reference: patient_gradcam.py:308-362): ``elbow.npz`` of
        {distortions, clusters, n_sequences} under
        ``dtw_clustering/<patho>/<patient>/``.  Returns {(patient, target):
        {n_sequences, clusters, distortions, distance_matrix, spans, cams
        (B, S, L') uint8, outputs (B, 2)}}."""
        results = {}
        for pt in self.gt.patients():
            rows = self._patient_rows(pt)
            data = self._gather(rows.index)["data"]  # (B, S, C, L)
            for target in self.get_target(rows.y[0]):
                dirname = os.path.join(self.results_dir, "dtw_clustering",
                                       PATHO_NAME[target], str(pt))
                os.makedirs(dirname, exist_ok=True)
                with self._stage("cams"):
                    cams, outs = self._read_cams_batch(
                        data, np.full(len(data), target))  # (B, S, L')
                with self._stage("spans"):
                    cams224 = upsample_cam(cams.reshape(-1, cams.shape[-1]))
                    breaths = data[:, :, 0, :].reshape(-1, data.shape[-1])
                    spans = self._cam_active_spans(
                        cams224, breaths, sequence_thresh, seq_min_len)
                D = self._pairwise_dtw_matrix(spans)
                n = len(spans)
                # the reference sweeps k = 2..20 whatever the span count
                # (patient_gradcam.py:353); clamped to it, as in the JAX
                # package
                ks = list(range(2, min(max_clusters, n) + 1))
                with self._stage("kmedoids"):
                    distortions = []
                    for k in ks:
                        medoids = KMedoids(
                            k, metric="precomputed").fit(D).medoid_indices_
                        distortions.append(float(
                            np.min(D[:, medoids], axis=1).sum() / max(n, 1)))
                np.savez(os.path.join(dirname, "elbow.npz"),
                         distortions=np.asarray(distortions),
                         clusters=np.asarray(ks), n_sequences=n)
                if distortions:
                    figures.draw_or_refuse([(
                        os.path.join(dirname, "elbow.png"),
                        functools.partial(
                            draw_elbow, ks=ks, distortions=distortions,
                            title="patient: {} target: {}".format(
                                pt, self.target)))], self.cam.device)
                results[(str(pt), int(target))] = {
                    "n_sequences": n,
                    "clusters": ks,
                    "distortions": distortions,
                    "distance_matrix": D,
                    "spans": spans,
                    "cams": cams,
                    "outputs": outs,
                }
        return results

    def plot_grads(self, out_path=None):
        """Per-call cam gradient norms split by predicted class
        (reference: patient_gradcam.py:365-375): (ards, other), and with
        ``out_path`` their histograms as a PNG on the CPU host.  Needs a
        cam built with ``record_grads=True`` and an op run first."""
        grads = getattr(self.cam, "grads", [])
        preds = getattr(self.cam, "preds", [])
        if not grads:
            raise ValueError(
                "no recorded gradients: construct PatientGradCam with a "
                "cam built record_grads=True and run an op first")
        norms = np.array([float(np.sqrt((np.asarray(g) ** 2).sum()))
                          for g in grads])
        outputs = np.array([
            int(np.asarray(p).reshape(-1, p.shape[-1])[0].argmax())
            for p in preds])
        ards, other = norms[outputs == 1], norms[outputs == 0]
        if out_path:
            figures.draw_or_refuse([(out_path, lambda path: draw_grads(
                path, ards, other))], self.cam.device)
        return ards, other

    def do_op(self, op, **kwargs):
        """The reference's --ops surface
        (reference: patient_gradcam.py:384,421-437)."""
        return {
            "medians": self.do_medians,
            "averages": self.do_averages,
            "sample_seqs": self.do_sample_sequences,
            "read_cam": self.do_read_cam,
            "rand_sample": self.do_rand_sample,
            "dtw_clust": self.do_dtw_clust,
            "cam_by_hour": self.do_cam_by_hour,
        }[op](**kwargs)
