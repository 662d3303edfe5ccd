"""Side-by-side comparison of explanation methods per patient-hour.

Counterpart of ``deepards_tpu/explain/explainer_comparison.py``
(reference: deepards/explainer_comparison.py:28-242): for the patients a
run classified correctly, GradCAM summaries, ProtoPNet's strongest
prototype and a classical model's top feature, window by window.  Frames
are dicts of aligned columns (name -> list) under the JAX package's
column names; the merge of the cam and prototype summaries is the JAX
package's outer merge on (window_index, patient), its rows in the merge's
sorted key order and NaN where one side has no window.
"""
import numpy as np

from deepards_tpu_torch.data.pipeline import gather_pipeline

CAM_COLUMNS = ["window_index", "hour", "cam_mean", "cam_peak_pos"]
KEYS = ("window_index", "patient")


def _outer_merge(left, right, suffix="_pp"):
    """pandas' ``left.merge(right, on=KEYS, how="outer", suffixes=("",
    suffix))`` for frames whose keys are unique: the union of the keys,
    sorted; the left's columns, then the right's other columns (suffixed
    where the left has one of the name); NaN where a side lacks the key."""
    def rows(frame):
        return {k: i for i, k in enumerate(zip(*(frame[c] for c in KEYS)))}

    left_rows, right_rows = rows(left), rows(right)
    keys = sorted(set(left_rows) | set(right_rows))
    out = {}
    for name in left:
        if name in KEYS:
            out[name] = [k[KEYS.index(name)] for k in keys]
        else:
            out[name] = [left[name][left_rows[k]] if k in left_rows
                         else np.nan for k in keys]
    for name in right:
        if name not in KEYS:
            out[name + suffix if name in left else name] = [
                right[name][right_rows[k]] if k in right_rows else np.nan
                for k in keys]
    return out


class ExplainerComparison:
    """``results``: a run's ``DeepARDSResults`` (rows of patient, patho,
    prediction and epoch_num, among others)."""

    def __init__(self, dataset, results):
        self.dataset = dataset
        self.results = results
        self.gt = dataset.get_ground_truth()
        # the cams run on the fold's transformed windows
        self.pipeline = gather_pipeline(dataset)

    def correctly_classified_patients(self):
        rows = self.results.results
        last = max(r["epoch_num"] for r in rows)
        return [r["patient"] for r in rows
                if r["epoch_num"] == last and r["patho"] == r["prediction"]]

    def gradcam_summary(self, cam_generator, patient_id, max_windows=8):
        """Mean cam intensity and peak position of a patient's first
        ``max_windows`` windows, with their hours."""
        rows = self.gt.select(self.gt.patient == patient_id)
        out = {c: [] for c in CAM_COLUMNS}
        for idx, y, hour in list(zip(rows.index, rows.y,
                                     rows.hour))[:max_windows]:
            window = self.pipeline(self.dataset.cache.data[int(idx)])
            cam, _ = cam_generator.generate_cam(window, int(y))
            out["window_index"].append(int(idx))
            out["hour"].append(float(hour))
            out["cam_mean"].append(float(np.asarray(cam, np.float64).mean()))
            out["cam_peak_pos"].append(int(np.argmax(cam)))
        return out

    def protopnet_summary(self, activation_frame, patient_id):
        """The strongest prototype of each of a patient's windows in
        ``activation_frame`` (``prototypes.prototype_activation_frame``),
        in the frame's order."""
        rows = self.gt.select(self.gt.patient == patient_id)
        hours = dict(zip(rows.index.tolist(), rows.hour.tolist()))
        keep = np.isin(activation_frame["window_index"], rows.index)
        protos = np.stack([activation_frame[c][keep]
                           for c in activation_frame
                           if c.startswith("proto_")], axis=1)
        index = activation_frame["window_index"][keep]
        return {
            "window_index": index.tolist(),
            "hour": [float(hours[i]) for i in index.tolist()],
            "best_prototype": protos.argmax(axis=1).tolist(),
            "prediction": activation_frame["prediction"][keep].tolist(),
        }

    def compare(self, cam_generator=None, activation_frame=None,
                rf_importances=None):
        """Per correctly classified patient, the merged summaries of the
        methods given, the patients' rows one after another."""
        frames = []
        for pt in self.correctly_classified_patients():
            merged = None
            if cam_generator is not None:
                merged = self.gradcam_summary(cam_generator, pt)
                merged["patient"] = [pt] * len(merged["window_index"])
            if activation_frame is not None:
                pp = self.protopnet_summary(activation_frame, pt)
                pp["patient"] = [pt] * len(pp["window_index"])
                merged = pp if merged is None else _outer_merge(merged, pp)
            if merged is not None:
                frames.append(merged)
        out = {}
        for frame in frames:
            for c in frame:
                out.setdefault(c, [])
        for frame in frames:
            n = len(frame["window_index"])
            for c in out:
                out[c].extend(frame.get(c, [np.nan] * n))
        if rf_importances is not None and out:
            top = str(max(rf_importances, key=rf_importances.get))
            out["rf_top_feature"] = [top] * len(out["window_index"])
        return out
