"""Siamese triplet dataset: (window, positive, negative) per sample.

Counterpart of ``deepards_tpu/data/siamese_dataset.py``, a sampling view
over an ``ARDSRawDataset``'s window cache (reference: deepards/dataset.py:
1463-1620): the anchors are the windows w of every patient with two or
more windows, each with w + 1 (the next window of its patient in the
cache) as its positive; a negative is a window of another patient, drawn
by rejection from a numpy ``default_rng(seed)`` stream.  The same seed
draws the same triplets as the JAX package's dataset.  Triplets are
absolute cache indices, so a trainer gathers their windows from a cache
uploaded to the device.
"""
import numpy as np

from deepards_tpu_torch.data.dataset import ARDSRawDataset


class SiameseWindowDataset:
    def __init__(self, data_path=None, experiment_num=1, n_sub_batches=20,
                 dataset_type="unpadded_centered_sequences", cohort_file=None,
                 train=True, to_pickle=None, base_dataset=None, seed=42):
        if base_dataset is None:
            base_dataset = ARDSRawDataset(
                data_path, experiment_num, cohort_file, n_sub_batches,
                dataset_type, train=train, kfold_num=None,
                total_kfolds=None, holdout_set_type="main", seed=seed)
        self.base = base_dataset
        self.train = train
        self._rng = np.random.default_rng(seed)
        self._build_index()
        if to_pickle:
            self.base.save(to_pickle)

    @property
    def n_sub_batches(self):
        return self.base.n_sub_batches

    @property
    def scaling_factors(self):
        return self.base.scaling_factors

    @scaling_factors.setter
    def scaling_factors(self, value):
        self.base.scaling_factors = value

    def scaling_for_current_fold(self):
        return self.base.scaling_for_current_fold()

    def _build_index(self):
        """Anchors and positives: consecutive cache windows of a patient,
        patients with a single window dropped (reference:
        dataset.py:1491-1498)."""
        by_patient = {}
        for i, pt in enumerate(self.base.cache.patient_idx.tolist()):
            by_patient.setdefault(pt, []).append(i)
        anchors, positives = [], []
        for idxs in by_patient.values():
            anchors += idxs[:-1]
            positives += idxs[1:]
        self.anchor_idx = np.asarray(anchors, np.int64)
        self.pos_idx = np.asarray(positives, np.int64)

    def __len__(self):
        return len(self.anchor_idx)

    def sample_triplet_indices(self, rel_indices):
        """Anchors ``rel_indices`` -> (anchor, positive, negative) absolute
        cache indices; each negative drawn from the generator until it
        is another patient's window."""
        patient = self.base.cache.patient_idx
        n_windows = len(patient)
        a = self.anchor_idx[rel_indices]
        p = self.pos_idx[rel_indices]
        neg = np.empty(len(a), np.int64)
        for k, ai in enumerate(a.tolist()):
            own = patient[ai]
            while True:
                j = int(self._rng.integers(0, n_windows))
                if patient[j] != own:
                    neg[k] = j
                    break
        return a, p, neg

    def sample_triplets(self, rel_indices):
        """Anchors ``rel_indices`` -> the raw (anchor, positive, negative)
        windows."""
        data = self.base.cache.data
        a, p, neg = self.sample_triplet_indices(rel_indices)
        return data[a], data[p], data[neg]

    @classmethod
    def from_pickle(cls, path, *args, **kwargs):
        """Over a saved ``.npz`` dataset, with the default seed (42), as
        the JAX package's."""
        return cls(base_dataset=ARDSRawDataset.from_pickle(path))
