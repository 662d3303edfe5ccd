"""2D breath-image dataset: 224-sample rows stacked into 224x224 images.

Counterpart of ``deepards_tpu/data/img_dataset.py`` (the reference
ImgARDSDataset, deepards/dataset.py:1623-1973), host numpy as there:
per-patient row accumulation with a zero-padded last image, optional FFT
channels, per-fold per-channel scaling, k-fold splits with oversampling,
the bbox dataset (a foreign-patho row band spliced in from a patient of
the same test fold, with its band boxes and labels), the patho-mix
dataset (chunks of same-patho images) and the train split's 2D transforms.
Every draw comes from the dataset's own ``np.random.Generator`` in the JAX
package's order, so a seed gives the same images, splices and warps.

``get_ground_truth`` gives the JAX package's ``get_ground_truth_df`` as
arrays (``GroundTruth``), with no pandas.  ``gather`` normalizes by the
current fold's scaling, so the trainer runs no batch pipeline over images.
"""
import numpy as np

from deepards_tpu_torch.data import sampling
from deepards_tpu_torch.data.dataset import GroundTruth
from deepards_tpu_torch.data.img_transforms import two_dim_transforms

SEQ_LEN = 224


def image_channels(add_fft=False, fft_only=False, fft_real_only=False):
    """An image's C under the FFT options, as ``_fft_channels`` stacks
    them: the flow image (unless only ``fft_only``), and with ``add_fft``
    or ``fft_only`` the FFT's real part and, unless ``fft_real_only``, its
    imaginary part."""
    if not (add_fft or fft_only):
        return 1
    return int(add_fft) + (1 if fft_real_only else 2)


class ImgARDSDataset:
    def __init__(self, raw_dataset, extra_transforms=(), add_fft=False,
                 fft_only=False, fft_real_only=False, bbox=False,
                 same_patho_mix=False, butter_filter=None, seed=42):
        self.raw = raw_dataset
        self.train = raw_dataset.train
        self.total_kfolds = raw_dataset.total_kfolds
        self.kfold_num = raw_dataset.kfold_num
        self.dataset_type = raw_dataset.dataset_type
        self.seq_len = SEQ_LEN
        self.bbox = bbox
        self.add_fft = add_fft
        self.fft_only = fft_only
        self.fft_real_only = fft_real_only
        self.oversample_minority = getattr(
            raw_dataset, "oversample_minority", False)
        self.oversample_all_factor = getattr(
            raw_dataset, "oversample_all_factor", 1.0)
        self._rng = np.random.default_rng(seed)
        self.transforms = [
            two_dim_transforms[name]() for name in (extra_transforms or [])
        ]
        if butter_filter is not None:
            from scipy.signal import butter, sosfilt

            sos = butter(10, butter_filter, fs=50, output="sos")
            self.butter_filter = lambda x: sosfilt(sos, x, axis=-2)
        else:
            self.butter_filter = None
        if self.dataset_type == "padded_breath_by_breath":
            raise NotImplementedError(
                "padded dataset types not implemented for 2D!")
        self._make_images()
        if self.train:
            self.derive_scaling_factors()
        if bbox:
            # both splits get band splices (reference:
            # dataset.py:1776-1825), so the test split has a held-out
            # detection metric
            self.make_bbox_dataset()
        if same_patho_mix and self.train:
            self.make_patho_mix_dataset()
        if self.kfold_num is not None:
            self.set_kfold_indexes_for_fold(self.kfold_num)

    # -- construction ---------------------------------------------------------

    def _fft_channels(self, img):
        """The image's FFT channels over W.  The reference's fftshift has
        no axes argument (dataset.py:1708), so besides centring the
        frequency axis it rolls the rows by H//2: ``axes=(1, 2)`` on
        (C, H, W) does the same."""
        trans = np.fft.fftshift(np.fft.fft(img, axis=2), axes=(1, 2))
        chans = ([trans.real] if self.fft_real_only
                 else [trans.real, trans.imag])
        chans = [c.astype(np.float32) for c in chans]
        if self.add_fft:
            return np.concatenate([img] + chans, axis=0)
        return np.concatenate(chans, axis=0)

    def _make_images(self):
        """Each patient's window rows, in cache order, cut into 224-row
        images, the last zero-padded (reference: make_dataset_from_raw
        :1827-1855, _append_to_mat :1680, _finish_mat :1698)."""
        cache = self.raw.cache
        images, patients, targets, hours = [], [], [], []
        cur_rows, cur_hours = [], []
        last_pt = last_target = None

        def finish(pt, target, hrs):
            if not cur_rows:
                return
            rows = np.concatenate(cur_rows, axis=0)
            pad = SEQ_LEN - rows.shape[0]
            if pad > 0:
                rows = np.concatenate(
                    [rows, np.zeros((pad, SEQ_LEN), np.float32)])
            img = rows[None]  # (1, H, W)
            if self.add_fft or self.fft_only:
                img = self._fft_channels(img)
            images.append(img.astype(np.float32))
            patients.append(pt)
            targets.append(target)
            h = np.asarray(hrs, np.float32)
            hours.append(h[0] if len(h) else np.nan)

        for i in range(len(cache)):
            pt = cache.patients[cache.patient_idx[i]]
            data = cache.data[i][:, 0, :]  # (S, L): the first channel
            target = cache.target[i]
            if pt != last_pt and cur_rows:
                finish(last_pt, last_target, cur_hours)
                cur_rows, cur_hours = [], []
            space = SEQ_LEN - sum(r.shape[0] for r in cur_rows)
            if data.shape[0] <= space:
                cur_rows.append(data)
                cur_hours.extend(cache.hours[i][:data.shape[0]].tolist())
            else:
                cur_rows.append(data[:space])
                cur_hours.extend(cache.hours[i][:space].tolist())
                finish(pt, target, cur_hours)
                cur_rows = [data[space:]]
                cur_hours = cache.hours[i][space:].tolist()
            last_pt, last_target = pt, target
        finish(last_pt, last_target, cur_hours)

        self.images = np.stack(images) if images else np.zeros(
            (0, image_channels(self.add_fft, self.fft_only,
                               self.fft_real_only), SEQ_LEN, SEQ_LEN),
            np.float32)
        self.patients = sorted(set(patients))
        pt_map = {p: i for i, p in enumerate(self.patients)}
        self.patient_idx = np.array([pt_map[p] for p in patients], np.int32)
        self.target = np.stack(targets).astype(np.float32)
        self.hours = np.asarray(hours, np.float32)
        self.mixed_images = None
        self.bbox_targets = None

    # -- scaling / splits -----------------------------------------------------

    def _patient_per_row(self):
        return np.array([self.patients[i] for i in self.patient_idx])

    def set_kfold_patient_splits(self):
        if getattr(self, "kfold_patient_splits", None):
            return self.kfold_patient_splits
        y = self.target.argmax(axis=1)
        by_class = {0: [], 1: []}
        seen = set()
        for cls in (0, 1):
            for i in range(len(self.images)):
                p = self.patients[self.patient_idx[i]]
                if y[i] == cls and p not in seen:
                    seen.add(p)
                    by_class[cls].append(p)
        self.kfold_patient_splits = sampling.stratified_patient_kfold(
            by_class, self.total_kfolds)
        return self.kfold_patient_splits

    def get_kfold_indexes_for_fold(self, kfold_num, train=None):
        self.set_kfold_patient_splits()
        train = self.train if train is None else train
        pts = self.kfold_patient_splits[kfold_num][
            "train" if train else "test"]
        return sampling.patients_to_indices(self._patient_per_row(), pts)

    def set_kfold_indexes_for_fold(self, kfold_num):
        self.kfold_num = kfold_num
        self.kfold_indexes = self.get_kfold_indexes_for_fold(kfold_num)
        if self.train and self.oversample_minority:
            labels = self.target[self.kfold_indexes].argmax(axis=1)
            self.kfold_indexes = sampling.oversample_minority(
                self.kfold_indexes, labels, self._rng)

    def derive_scaling_factors(self):
        """Per-channel scalar mu/std over each fold's train images
        (reference: dataset.py:1719-1774)."""
        if self.total_kfolds:
            indices = {k: self.get_kfold_indexes_for_fold(k, train=True)
                       for k in range(self.total_kfolds)}
        else:
            indices = {None: np.arange(len(self.images))}
        self.scaling_factors = {}
        for k, idx in indices.items():
            obs = self.images[np.asarray(idx, np.int64)]
            mu = obs.mean(axis=(0, 2, 3), dtype=np.float64)
            std = obs.std(axis=(0, 2, 3), dtype=np.float64)
            self.scaling_factors[k] = (mu.astype(np.float32),
                                       std.astype(np.float32))

    def scaling_for_current_fold(self):
        return self.scaling_factors[self.kfold_num]

    # -- derived datasets -----------------------------------------------------

    def _test_fold_of_row(self):
        """Each image's fold: the one whose TEST split holds it."""
        out = np.full(len(self.images), -1, np.int64)
        for k in range(self.total_kfolds):
            for i in self.get_kfold_indexes_for_fold(k, train=False):
                out[int(i)] = k
        return out

    def make_bbox_dataset(self):
        """Splice a foreign-patho row band into each image and emit band
        boxes/labels (reference: make_bbox_dataset:1776-1825)."""
        y = self.target.argmax(axis=1)
        fold_of = self._test_fold_of_row()
        mixed = self.images.copy()
        boxes_out, labels_out = [], []
        for idx in range(len(self.images)):
            own = int(y[idx])
            # donors: the same test fold (no k-fold crossover), the other
            # patho, another patient
            donors = np.nonzero(
                (fold_of == fold_of[idx]) & (y != own)
                & (self.patient_idx != self.patient_idx[idx]))[0]
            if not len(donors):
                donors = np.nonzero(y != own)[0]
            donor = int(self._rng.choice(donors))
            n_rows = int(self._rng.integers(SEQ_LEN // 4, SEQ_LEN // 3))
            row_start = int(self._rng.integers(10, SEQ_LEN - n_rows - 11))
            row_end = row_start + n_rows
            mixed[idx, :, row_start:row_end] = (
                self.images[donor, :, row_start:row_end])
            boxes_out.append(np.array([
                [0, 0, SEQ_LEN, row_start],
                [0, row_start, SEQ_LEN, row_end],
                [0, row_end, SEQ_LEN, SEQ_LEN],
            ], np.float32))
            labels_out.append(np.array([own, (own + 1) % 2, own], np.int64))
        self.mixed_images = mixed
        self.bbox_targets = {"boxes": np.stack(boxes_out),
                             "labels": np.stack(labels_out)}

    def make_patho_mix_dataset(self, n_chunks=8, mix_prob=0.5):
        """Chunk-mix images with SAME-patho donors
        (reference: make_patho_mix_dataset:1857-1921)."""
        y = self.target.argmax(axis=1)
        fold_of = self._test_fold_of_row()
        rows_per_chunk = SEQ_LEN // n_chunks
        mixed = self.images.copy()
        for idx in range(len(self.images)):
            own = int(y[idx])
            donors = np.nonzero(
                (fold_of == fold_of[idx]) & (y == own)
                & (self.patient_idx != self.patient_idx[idx]))[0]
            if not len(donors):
                continue
            for c in range(n_chunks):
                if self._rng.random() > mix_prob:
                    donor = int(self._rng.choice(donors))
                    dc = int(self._rng.integers(0, n_chunks))
                    s, e = c * rows_per_chunk, (c + 1) * rows_per_chunk
                    ds, de = dc * rows_per_chunk, (dc + 1) * rows_per_chunk
                    mixed[idx, :, s:e] = self.images[donor, :, ds:de]
        self.mixed_images = mixed

    # -- access ---------------------------------------------------------------

    def __len__(self):
        if self.kfold_num is None:
            return len(self.images)
        return len(self.kfold_indexes)

    @property
    def data_shape(self):
        """(C, H, W) of one image."""
        return self.images.shape[1:]

    def current_indices(self):
        if self.kfold_num is None:
            return np.arange(len(self.images), dtype=np.int64)
        return np.asarray(self.kfold_indexes, np.int64)

    def gather(self, absolute_indices):
        """{index, data (B, C, H, W) normalized, target[, boxes, labels]}:
        the mixed images for the train split (and both splits of the bbox
        dataset), then the Butterworth filter over H, then the train
        split's transforms image by image."""
        idx = np.asarray(absolute_indices, np.int64)
        mixed = self.mixed_images is not None and (self.train or self.bbox)
        data = (self.mixed_images if mixed else self.images)[idx]
        mu, std = self.scaling_for_current_fold()
        data = (data - mu[None, :, None, None]) / std[None, :, None, None]
        if self.butter_filter is not None:
            data = self.butter_filter(data)
        if self.train and self.transforms:
            data = np.stack([self._apply_transforms(img) for img in data])
        out = {"index": idx, "data": data.astype(np.float32),
               "target": self.target[idx]}
        if self.bbox_targets is not None:
            out["boxes"] = self.bbox_targets["boxes"][idx]
            out["labels"] = self.bbox_targets["labels"][idx]
        return out

    def _apply_transforms(self, img):
        for t in self.transforms:
            img = t(img, self._rng)
        return np.ascontiguousarray(img)

    def get_ground_truth(self):
        """Truth of the current indices, in their order."""
        idx = self.current_indices()
        return GroundTruth(index=idx, patient=self._patient_per_row()[idx],
                           y=self.target[idx].argmax(axis=1),
                           hour=self.hours[idx])

    def seq_hours_for(self, absolute_indices):
        return self.hours[np.asarray(absolute_indices, np.int64)]
