"""Reader/writer for per-patient processed breath files.

The reference consumes ``<name>.raw.npy`` / ``<name>.processed.npy`` file
pairs through ``ventmap.raw_utils.read_processed_file`` which yields one
dict per breath with keys ``flow``, ``pressure``, ``rel_bn``, ``vent_bn``,
``abs_bs`` (reference: deepards/dataset.py:1024-1025 and SURVEY.md L0 row).

A copy of ``deepards_tpu/data/reader.py``: pure numpy/scipy, kept in the port
so that it imports nothing of the JAX package.

We keep the same on-disk pairing but use a dense, array-native layout that
loads with a single ``np.load`` each (no pickled object graphs):

- ``<name>.raw.npy``: float32 array, shape (total_samples, 2) with columns
  (flow, pressure) concatenated over breaths.
- ``<name>.processed.npy``: structured array with one record per breath:
  ``rel_bn`` (i4), ``vent_bn`` (i4), ``start`` (i8), ``length`` (i4),
  ``abs_bs`` (S26 timestamp 'YYYY-MM-DD HH-MM-SS.ffffff').

For compatibility we also accept legacy object-array files where each
element is a per-breath dict that already carries ``flow``.
"""
import numpy as np

PROCESSED_DTYPE = np.dtype([
    ("rel_bn", "i4"),
    ("vent_bn", "i4"),
    ("start", "i8"),
    ("length", "i4"),
    ("abs_bs", "S26"),
])

ABS_BS_FORMAT = "%Y-%m-%d %H-%M-%S.%f"


def write_processed_file(breaths, raw_path, processed_path=None):
    """Write a list of breath dicts to a raw/processed npy file pair.

    Each breath dict needs: flow (list/array), rel_bn, vent_bn, abs_bs
    (string in ABS_BS_FORMAT); pressure is optional (zeros when absent).
    """
    if processed_path is None:
        processed_path = raw_path.replace(".raw.npy", ".processed.npy")
    records = np.empty(len(breaths), dtype=PROCESSED_DTYPE)
    chunks = []
    cursor = 0
    for i, b in enumerate(breaths):
        flow = np.asarray(b["flow"], dtype=np.float32)
        pressure = np.asarray(
            b.get("pressure", np.zeros_like(flow)), dtype=np.float32
        )
        chunk = np.stack([flow, pressure], axis=1)
        chunks.append(chunk)
        records[i] = (
            int(b["rel_bn"]),
            int(b["vent_bn"]),
            cursor,
            len(flow),
            str(b["abs_bs"]).encode(),
        )
        cursor += len(flow)
    raw = (
        np.concatenate(chunks, axis=0)
        if chunks
        else np.zeros((0, 2), dtype=np.float32)
    )
    np.save(raw_path, raw)
    np.save(processed_path, records)
    return raw_path, processed_path


def read_processed_file(raw_path, processed_path=None):
    """Yield breath dicts from a raw/processed npy pair.

    Yields dicts with keys: flow, pressure, rel_bn, vent_bn, abs_bs, dt.
    """
    if processed_path is None:
        processed_path = raw_path.replace(".raw.npy", ".processed.npy")
    processed = np.load(processed_path, allow_pickle=True)

    if processed.dtype == object:
        # legacy object-array format: per-breath dicts
        raw = np.load(raw_path, allow_pickle=True)
        for i, rec in enumerate(processed):
            rec = dict(rec)
            if "flow" not in rec:
                rb = raw[i]
                rec["flow"] = list(np.asarray(rb["flow"], dtype=np.float64))
                rec["pressure"] = list(
                    np.asarray(rb.get("pressure", []), dtype=np.float64)
                )
            rec.setdefault("dt", 0.02)
            yield rec
        return

    raw = np.load(raw_path)
    for rec in processed:
        start = int(rec["start"])
        length = int(rec["length"])
        chunk = raw[start : start + length]
        yield {
            "rel_bn": int(rec["rel_bn"]),
            "vent_bn": int(rec["vent_bn"]),
            "abs_bs": rec["abs_bs"].decode(),
            "flow": chunk[:, 0].astype(np.float64),
            "pressure": chunk[:, 1].astype(np.float64),
            "dt": 0.02,
        }
