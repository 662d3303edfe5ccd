"""The fold's split, scaling and test order, worked out in plain NumPy.

Patients are the split unit.  They are listed OTHER first, then ARDS,
each class in the order of its first window, and given test folds as
scikit-learn's ``StratifiedKFold`` without shuffling gives them: a round
robin over the sorted labels sets each fold's share of a class, and each
class's patients take their folds in consecutive blocks.  The fold's
scaling is the mean and the standard deviation of each channel over its
train patients' windows, in float64.  Its test epoch visits the test
patients' windows in that list's order, each patient's in row order; its
train epoch a permutation of the train patients' rows, oversampled.
Either goes in batches whose last one is filled by repeating the order
from its start, the repeats masked out.
"""
import numpy as np
import torch


def patients_in_split_order(patient_of_row, class_of_row):
    """[(patient, class)]: OTHER (0) first, then ARDS (1), each in order
    of first window."""
    out = []
    for cls in (0, 1):
        seen = []
        for pt, y in zip(patient_of_row, class_of_row):
            if y == cls and pt not in seen:
                seen.append(pt)
        out += [(pt, cls) for pt in seen]
    return out


def test_folds(classes, n_folds):
    """The test fold of each patient, by StratifiedKFold's rule."""
    classes = np.asarray(classes)
    n_classes = len(set(classes.tolist()))
    ordered = np.sort(classes)
    allocation = np.asarray([
        np.bincount(ordered[i::n_folds], minlength=n_classes)
        for i in range(n_folds)])
    folds = np.empty(len(classes), dtype=np.int64)
    for k in range(n_classes):
        folds[classes == k] = np.arange(n_folds).repeat(allocation[:, k])
    return folds


def split(patient_of_row, class_of_row, n_folds, fold):
    """(train patients, test patients) of ``fold``, each in split order."""
    listed = patients_in_split_order(patient_of_row, class_of_row)
    folds = test_folds([y for _, y in listed], n_folds)
    train = [pt for (pt, _), f in zip(listed, folds) if f != fold]
    test = [pt for (pt, _), f in zip(listed, folds) if f == fold]
    return train, test


def rows_of(patient_of_row, patients):
    """Row indices of ``patients``' windows, patient by patient."""
    patient_of_row = np.asarray(patient_of_row)
    return np.concatenate([np.nonzero(patient_of_row == pt)[0]
                           for pt in patients]).astype(np.int64)


def oversampled(rows, class_of_row, seed):
    """``rows`` with minority-class rows drawn again until the classes
    balance: for each class short of the largest, ``default_rng(seed)``
    chooses that many of its rows with replacement, appended in class
    order."""
    rows = np.asarray(rows)
    labels = np.asarray(class_of_row)[rows]
    values, counts = np.unique(labels, return_counts=True)
    rng = np.random.default_rng(seed)
    out = [rows]
    for cls, count in zip(values, counts):
        if count < counts.max():
            out.append(rng.choice(rows[labels == cls],
                                  size=counts.max() - count, replace=True))
    return np.concatenate(out)


def bucket(n):
    """The windows a nested patient of ``n`` is padded to: the next
    power of two."""
    b = 1
    while b < n:
        b *= 2
    return b


def scaling(data, rows, device, chunk=4096):
    """Per-channel (mean, std) over ``rows`` of the (N, S, C, L) host
    array ``data``, in float64 on ``device``, a chunk of rows at a
    time."""
    rows = np.asarray(rows)
    parts = [rows[i:i + chunk] for i in range(0, len(rows), chunk)]

    def chunks():
        for part in parts:
            yield torch.from_numpy(data[part]).to(device).double()

    count = len(rows) * data.shape[1] * data.shape[3]
    mean = sum(x.sum(dim=(0, 1, 3)) for x in chunks()) / count
    square = sum(((x - mean.reshape(1, 1, -1, 1)) ** 2).sum(dim=(0, 1, 3))
                 for x in chunks())
    return mean.cpu().numpy(), torch.sqrt(square / count).cpu().numpy()


def batches(rows, batch_size):
    """(steps, batch) row ids and 0/1 masks of an epoch over ``rows`` in
    that order."""
    steps = -(-len(rows) // batch_size)
    ids = np.resize(rows, steps * batch_size).reshape(steps, batch_size)
    masks = (np.arange(steps * batch_size) < len(rows)).astype(np.float32)
    return ids, masks.reshape(steps, batch_size)
