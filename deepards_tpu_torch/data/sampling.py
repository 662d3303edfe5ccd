"""Patient-level splitting and index resampling.

Counterpart of ``deepards_tpu/data/sampling.py``.  Stratified patient
k-fold / bootstrap / holdout splits plus minority oversampling,
whole-dataset oversampling, fractional-patient training, and
DTW-homogeneity undersampling, all on host index arrays.  The k-fold split
is scikit-learn's ``StratifiedKFold`` written in numpy: the same folds,
shuffled or not, for the same seed.
"""
import numpy as np


def stratified_kfold_test_folds(y, n_splits, shuffle=False, seed=None):
    """The test fold of each sample, as ``StratifiedKFold(n_splits,
    shuffle, random_state=seed)`` assigns them: classes are numbered in
    order of first appearance, each fold's share of a class comes from a
    round robin over the sorted labels, and each class's samples take
    their folds in blocks, shuffled by ``RandomState(seed)`` when asked."""
    y = np.asarray(y)
    if n_splits > len(y):
        raise ValueError(
            "Cannot have number of splits n_splits={} greater than the "
            "number of samples: n_samples={}.".format(n_splits, len(y)))
    _, y_idx, y_inv = np.unique(y, return_index=True, return_inverse=True)
    _, class_perm = np.unique(y_idx, return_inverse=True)
    y_encoded = class_perm[y_inv]
    n_classes = len(y_idx)
    y_counts = np.bincount(y_encoded)
    if np.all(n_splits > y_counts):
        raise ValueError(
            "n_splits={} cannot be greater than the number of members in "
            "each class.".format(n_splits))
    rng = np.random.RandomState(seed) if shuffle else None
    y_order = np.sort(y_encoded)
    allocation = np.asarray([
        np.bincount(y_order[i::n_splits], minlength=n_classes)
        for i in range(n_splits)
    ])
    test_folds = np.empty(len(y), dtype="i")
    for k in range(n_classes):
        folds_for_class = np.arange(n_splits).repeat(allocation[:, k])
        if shuffle:
            rng.shuffle(folds_for_class)
        test_folds[y_encoded == k] = folds_for_class
    return test_folds


def stratified_patient_kfold(patients_by_class, total_kfolds, shuffle=False,
                             seed=None):
    """Patient-stratified KFold: returns {fold: {train: [...], test: [...]}}.

    ``patients_by_class``: dict {0: [patients], 1: [patients]}.  Patients
    (not windows) are the split unit.
    """
    all_patients = np.append(
        np.asarray(patients_by_class[0]), np.asarray(patients_by_class[1])
    )
    patho = np.array(
        [0] * len(patients_by_class[0]) + [1] * len(patients_by_class[1])
    )
    test_folds = stratified_kfold_test_folds(
        patho, total_kfolds, shuffle=shuffle, seed=seed)
    return {
        i: {"train": all_patients[test_folds != i],
            "test": all_patients[test_folds == i]}
        for i in range(total_kfolds)
    }




def bootstrap_split(patients_by_class, rng):
    """One 80/20 bootstrap-with-replacement split fashioned as fold 0
    (reference: deepards/dataset.py:792-807)."""
    other, ards = (
        np.asarray(patients_by_class[0]),
        np.asarray(patients_by_class[1]),
    )
    other_train = rng.choice(other, size=int(len(other) * 0.8), replace=True)
    ards_train = rng.choice(ards, size=int(len(ards) * 0.8), replace=True)
    other_pool = sorted(set(other).difference(other_train))
    ards_pool = sorted(set(ards).difference(ards_train))
    other_test = rng.choice(other_pool, size=int(len(ards) * 0.2), replace=True)
    ards_test = rng.choice(ards_pool, size=int(len(ards) * 0.2), replace=True)
    return {
        0: {
            "train": np.append(other_train, ards_train),
            "test": np.append(other_test, ards_test),
        }
    }


def patients_to_indices(patient_per_row, patients):
    """Map a patient list (possibly with bootstrap duplicates) to row
    indices, preserving duplicates (reference: deepards/dataset.py:811-820)."""
    out = []
    patient_per_row = np.asarray(patient_per_row)
    for pt in patients:
        out.extend(np.nonzero(patient_per_row == pt)[0].tolist())
    return np.asarray(out, dtype=np.int64)


def oversample_minority(indices, labels, rng):
    """Randomly duplicate minority-class rows until classes balance
    (RandomOverSampler equivalent; reference: deepards/dataset.py:566-573)."""
    indices = np.asarray(indices)
    labels = np.asarray(labels)
    classes, counts = np.unique(labels, return_counts=True)
    if len(classes) < 2:
        return indices
    max_count = counts.max()
    out = [indices]
    for cls, count in zip(classes, counts):
        if count < max_count:
            extra = rng.choice(
                indices[labels == cls], size=max_count - count, replace=True
            )
            out.append(extra)
    return np.concatenate(out)


def oversample_all(indices, labels, factor, rng):
    """Oversample every class by ``factor``
    (reference: deepards/dataset.py:575-582)."""
    if factor <= 1.0:
        return np.asarray(indices)
    indices = np.asarray(indices)
    labels = np.asarray(labels)
    out = []
    for cls in np.unique(labels):
        cls_idx = indices[labels == cls]
        n = int(len(cls_idx) * factor)
        out.append(cls_idx)
        out.append(rng.choice(cls_idx, size=n - len(cls_idx), replace=True))
    return np.concatenate(out)


def fractional_patients(indices, patient_per_row, patho_per_patient, frac,
                        rng):
    """Keep a balanced random subset of training patients
    (reference: deepards/dataset.py:596-623)."""
    if frac == 1.0:
        return np.asarray(indices)
    indices = np.asarray(indices)
    uniq = np.unique(np.asarray(patient_per_row)[indices])
    ards = [p for p in uniq if patho_per_patient[p] == 1]
    other = [p for p in uniq if patho_per_patient[p] == 0]
    n_per_class = int(np.floor(len(uniq) * frac)) // 2
    if n_per_class < 1:
        # a tiny cohort x small frac otherwise trickles down to an
        # empty train split and an opaque reshape crash at init time
        raise ValueError(
            "train_pt_frac={} of {} patients leaves zero training "
            "patients per class".format(frac, len(uniq)))
    keep = set(rng.choice(other, size=min(n_per_class, len(other)),
                          replace=False))
    keep.update(rng.choice(ards, size=min(n_per_class, len(ards)),
                           replace=False))
    mask = np.isin(np.asarray(patient_per_row)[indices], list(keep))
    return indices[mask]


def undersample_by_homogeneity(indices, dtw_scores, undersample_factor,
                               std_factor, rng):
    """Drop a fraction of the most DTW-homogeneous windows.

    The JAX package's counterpart of PatientLevelHomogeneityUndersampler
    (reference: deepards/dataset.py:76-106), kept as it computes: windows
    whose DTW score is within ``std_factor``·std of the median, both taken
    over every scored window (not per patient), are candidates; drop
    ``undersample_factor`` fraction of candidates.

    ``dtw_scores``: dict window_index -> score
    (``dtw.lib.build_patient_score_map``).  The trainer's datasets start
    with none, as the JAX package's do, so the trainer drops nothing.
    """
    if undersample_factor < 0:
        return np.asarray(indices)
    indices = np.asarray(indices)
    scores = np.array([dtw_scores.get(int(i), np.nan) for i in indices])
    valid = ~np.isnan(scores)
    med = np.nanmedian(scores) if valid.any() else 0.0
    std = np.nanstd(scores) if valid.any() else 0.0
    candidates = indices[valid & (np.abs(scores - med) <= std_factor * std)]
    n_drop = int(len(candidates) * undersample_factor)
    if n_drop == 0:
        return indices
    drop = set(rng.choice(candidates, size=n_drop, replace=False).tolist())
    return np.array([i for i in indices if int(i) not in drop])
