"""Per-breath predictions by hour and their DTW frames.

Counterpart of the data stage of ``deepards_tpu/eval/plots.py:24-52``
(reference: deepards/metrics.py:396-450): the test predictions expanded
to one row a breath with the breath's hour, then each patient's rolling
DTW frame through ``dtw.lib.analyze_patient`` (the DTW kernel on the
card).  The JAX frames are columns here: a dict of numpy arrays under
the frame's column names.  The drawing functions of that module need
matplotlib and are not ported (the plot flags stay refused).
"""
import numpy as np

from deepards_tpu_torch.dtw.lib import analyze_patient, as_columns


def process_pred_to_hour_for_dtw(pred_to_hour_frame, dataset):
    """Each prediction row repeated S times, one a breath of its window,
    each with its breath's hour: the window's S hours of
    ``dataset.cache.hours`` resized to S as ``np.resize`` does
    (reference: metrics.py:396-423).  Returns columns."""
    cols = as_columns(pred_to_hour_frame)
    repeat_n = dataset.cache.data.shape[1]
    index = np.asarray(cols["index"], np.int64)
    out = {k: np.repeat(np.asarray(v), repeat_n)
           for k, v in cols.items() if k != "hour"}
    hours = dataset.cache.hours[index].astype(np.float64)
    if hours.shape[1] != repeat_n:
        hours = np.stack([np.resize(h, repeat_n) for h in hours])
    out["hour"] = hours.reshape(-1)
    return out


def perform_dtw_preprocessing(results, test_dataset, cache_dir="dtw_cache",
                              device=None):
    """{patient: ``DTWFrame``} of the last predictions by hour
    (``results.pred_to_hour_frame``) on ``test_dataset``, one
    ``analyze_patient`` a patient in order of first appearance, each
    cached under ``cache_dir`` (reference: metrics.py:425-450)."""
    preds_by_hour = process_pred_to_hour_for_dtw(
        results.pred_to_hour_frame, test_dataset)
    return {pt: analyze_patient(pt, test_dataset, cache_dir, preds_by_hour,
                                device=device)
            for pt in dict.fromkeys(preds_by_hour["patient"].tolist())}
