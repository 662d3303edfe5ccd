"""ARDS window dataset: cohort ETL orchestration, splits, scaling.

Counterpart of ``deepards_tpu/data/dataset.py`` on numpy and the standard
library: the cohort CSV is read with ``csv`` and times are parsed with
``datetime``.  Windows live in a dense ``WindowCache`` (one (N, S, C, L)
array) built once on the host; normalization runs per batch on the device
(``deepards_tpu_torch.data.pipeline``).  The split and resampling
machinery works on index arrays and draws from the same numpy streams as
the JAX package, so both give the same windows, folds and oversampled
indexes.  The saved ``.npz`` + JSON header format is shared with the JAX
package, and the reference's pickles are read without pandas
(``from_reference_pickle``, through ``data.legacy_pickle``).
"""
import csv
import datetime
import json
import os
import re
from glob import glob
from typing import NamedTuple

import numpy as np

from deepards_tpu_torch.data import legacy_pickle, sampling
from deepards_tpu_torch.data.reader import read_processed_file
from deepards_tpu_torch.data.windowing import (
    SEQ_LEN,
    WindowCache,
    assemble_windows,
    perform_fft,
    rows_to_cache,
)

AUTOENCODER_TYPES = {"unpadded_downsampled_autoencoder_sequences"}

_ABS_BS_FORMATS = ("%Y-%m-%d %H-%M-%S.%f", "%Y-%m-%d %H:%M:%S.%f")
# the cohort's m/d/Y forms (ISO forms go through fromisoformat)
_COHORT_TIME_FORMATS = ("%m/%d/%Y %H:%M:%S", "%m/%d/%Y %H:%M", "%m/%d/%Y")
_STUDY_WINDOW = datetime.timedelta(hours=24)
# runtime attributes a saved dataset does not carry
_RUNTIME_DEFAULTS = dict(
    bootstrap=False, random_kfold=False, oversample_minority=False,
    oversample_all_factor=1.0, undersample_factor=-1,
    undersample_std_factor=0.2, train_patient_fraction=1.0,
    transforms=None, butter_low=None, butter_high=None,
    post_hoc_downsampling=None, fft_filtering_low=None,
    fft_filtering_high=None,
)


class GroundTruth(NamedTuple):
    """Per-window truth of a dataset's current indices, in their order."""

    index: np.ndarray    # absolute window index
    patient: np.ndarray  # patient id (str)
    y: np.ndarray        # class (argmax of the one-hot target)
    hour: np.ndarray     # hour into the study of the first sub-sequence

    def select(self, mask):
        """The rows where ``mask`` holds, in their order (a frame's
        boolean indexing)."""
        return GroundTruth(*(field[mask] for field in self))

    def patients(self):
        """Distinct patients in order of first appearance (a frame's
        ``patient.unique()``)."""
        return list(dict.fromkeys(self.patient.tolist()))


def _holdout_subdir(holdout_set_type, train, final_validation_set, kfold):
    """Data subdirectory selection (reference: deepards/dataset.py:450-471)."""
    if kfold:
        return "all_data"
    if holdout_set_type == "proto":
        return "prototrain" if train else "prototest"
    if holdout_set_type == "main":
        return "aim1_70_30_training" if train else "aim1_70_30_testing"
    if holdout_set_type == "random":
        if train:
            return "randomtrain"
        return "randomtest" if final_validation_set else "randomval"
    if holdout_set_type:
        if train:
            return "{}train".format(holdout_set_type)
        return (
            "{}test".format(holdout_set_type)
            if final_validation_set
            else "{}val".format(holdout_set_type)
        )
    raise ValueError("You must choose to either use kfold or a holdout set!")


def _patient_id_from_file(filename):
    """(reference: deepards/dataset.py:1295-1306)"""
    match = re.search(r"(0\d{3}RPI\d{10})", filename)
    if match:
        return match.groups()[0]
    pt_id = filename.split("/")[-2]
    try:
        float(pt_id)
        return pt_id
    except ValueError:
        raise ValueError(
            "could not find patient id in file: {}".format(filename)
        )


def _parse_abs_bs(abs_bs):
    """A breath's start time: 'Y-m-d H-M-S.f', 'Y-m-d H:M:S.f' or ISO."""
    if isinstance(abs_bs, bytes):
        abs_bs = abs_bs.decode("utf-8")
    for fmt in _ABS_BS_FORMATS:
        try:
            return datetime.datetime.strptime(abs_bs, fmt)
        except ValueError:
            continue
    return _parse_iso(abs_bs)


def _parse_iso(text):
    when = datetime.datetime.fromisoformat(text.strip())
    if when.tzinfo is not None:
        raise ValueError("time with a zone: {!r}".format(text))
    return when


def _parse_cohort_time(text):
    """A cohort time in ISO or m/d/Y form; raises on anything else."""
    try:
        return _parse_iso(text)
    except ValueError:
        pass
    for fmt in _COHORT_TIME_FORMATS:
        try:
            return datetime.datetime.strptime(text.strip(), fmt)
        except ValueError:
            continue
    raise ValueError("unrecognised cohort time: {!r}".format(text))


def read_cohort(cohort_file):
    """{patient_id: row} from the cohort CSV (the first row of each id)."""
    cohort = {}
    with open(cohort_file, newline="") as f:
        for row in csv.DictReader(f):
            cohort.setdefault(row["Patient Unique Identifier"].strip(), row)
    return cohort


class ARDSRawDataset:
    """Cohort of assembled breath windows with split machinery.

    Parameters mirror the JAX package's constructor.  Device-side transform
    knobs (butter filter, fft band filtering, post-hoc downsampling) are
    carried as attributes for ``deepards_tpu_torch.data.pipeline``.
    """

    seq_len = SEQ_LEN

    def __init__(
        self,
        data_path,
        experiment_num,
        cohort_file,
        n_sub_batches,
        dataset_type,
        cache=None,
        to_pickle=None,
        train=True,
        kfold_num=None,
        total_kfolds=None,
        oversample_minority=False,
        unpadded_downsample_factor=4.0,
        whole_patient_super_batch=False,
        holdout_set_type="main",
        train_patient_fraction=1.0,
        transforms=None,
        final_validation_set=False,
        drop_if_under_r2=0.0,
        drop_i_lim=False,
        drop_e_lim=False,
        truncate_e_lim=None,
        undersample_factor=-1,
        undersample_std_factor=0.2,
        oversample_all_factor=1.0,
        butter_low=None,
        butter_high=None,
        add_fft=False,
        only_fft=False,
        fft_real_only=False,
        random_kfold=False,
        bootstrap=False,
        post_hoc_downsampling=None,
        fft_filtering_low=None,
        fft_filtering_high=None,
        seed=42,
    ):
        self.train = train
        self.dataset_type = dataset_type
        self.experiment_num = experiment_num
        self.cohort_file = cohort_file
        self.total_kfolds = total_kfolds
        self.kfold_num = kfold_num
        self.kfold_patient_splits = dict()
        self.vent_bn_frac_missing = 0.5
        self.oversample_minority = oversample_minority
        self.oversample_all_factor = oversample_all_factor
        self.undersample_factor = undersample_factor
        self.undersample_std_factor = undersample_std_factor
        self.whole_patient_super_batch = whole_patient_super_batch
        self.train_patient_fraction = train_patient_fraction
        self.transforms = transforms
        self.drop_if_under_r2 = drop_if_under_r2
        self.unpadded_downsample_factor = unpadded_downsample_factor
        self.drop_i_lim = drop_i_lim
        self.drop_e_lim = drop_e_lim
        self.truncate_e_lim = truncate_e_lim
        self.butter_low = butter_low
        self.butter_high = butter_high
        self.add_fft = add_fft
        self.only_fft = only_fft
        self.fft_real_only = fft_real_only
        self.random_kfold = random_kfold
        self.bootstrap = bootstrap
        self.post_hoc_downsampling = post_hoc_downsampling
        self.fft_filtering_low = fft_filtering_low
        self.fft_filtering_high = fft_filtering_high
        self.seed = seed
        self._rng = np.random.default_rng(seed)
        self.dtw_scores = {}
        self.scaling_factors = {}

        if bootstrap:
            # bootstrap is fashioned as a 1-fold kfold
            # (reference: deepards/dataset.py:414-421)
            self.kfold_num = 0
            self.total_kfolds = 1

        if drop_i_lim and drop_e_lim:
            raise ValueError("You cannot drop both I and E lims!")
        if truncate_e_lim and drop_e_lim:
            raise ValueError(
                "You cant truncate the E lim and drop it at the same time"
            )
        if truncate_e_lim and round(truncate_e_lim % 0.02, 2) != 0.02:
            raise ValueError(
                "--truncate-e-lim must be given in increments divisible by 0.02!"
            )

        self.cohort = read_cohort(cohort_file)
        if cache is not None:
            self.cache = cache
            self.finalize_dataset_create(to_pickle)
            return

        subdir = _holdout_subdir(
            holdout_set_type, train, final_validation_set,
            self.kfold_num is not None,
        )
        raw_dir = os.path.join(
            data_path, "experiment{}".format(experiment_num), subdir, "raw"
        )
        if not os.path.exists(raw_dir):
            raise FileNotFoundError("No directory {} exists!".format(raw_dir))
        self.raw_files = sorted(glob(os.path.join(raw_dir, "*/*.raw.npy")))

        autocorr = None
        if drop_if_under_r2:
            if "unpadded" not in dataset_type:
                raise ValueError(
                    "Non-unpadded datasets are not supported with "
                    "drop_if_under_r2"
                )
            if self.total_kfolds is not None and not bootstrap:
                raise ValueError(
                    "kfold is not supported with drop_if_under_r2"
                )
            from deepards_tpu_torch.data.correlation import autocorr_r2

            autocorr = autocorr_r2

        rows, frames_dropped = assemble_windows(
            self._breath_stream(),
            dataset_type,
            n_sub_batches,
            unpadded_downsample_factor=unpadded_downsample_factor,
            drop_i_lim=drop_i_lim,
            drop_e_lim=drop_e_lim,
            truncate_e_lim=truncate_e_lim,
            vent_bn_frac_missing=self.vent_bn_frac_missing,
            drop_if_under_r2=drop_if_under_r2,
            autocorr_r2=autocorr,
        )
        self.cache = rows_to_cache(
            rows,
            frames_dropped,
            autoencoder_target=dataset_type in AUTOENCODER_TYPES,
        )
        perform_fft(self.cache, add_fft, only_fft, fft_real_only)
        self.finalize_dataset_create(to_pickle)

    # -- construction helpers -------------------------------------------------

    def _cohort_row(self, patient_id):
        if patient_id not in self.cohort:
            raise ValueError(
                "Could not find patient {} in cohort file".format(patient_id)
            )
        return self.cohort[patient_id]

    def _patient_start_time(self, patient_id):
        """Berlin-criteria time for ARDS patients, vent start otherwise
        (reference: deepards/dataset.py:1220-1231)."""
        row = self._cohort_row(patient_id)
        if row["Pathophysiology"] == "ARDS":
            text = row["Date when Berlin criteria first met (m/dd/yyy)"]
        else:
            text = row["vent_start_time"]
        if not (text or "").strip():
            raise ValueError(
                "Could not find valid start time for {}".format(patient_id)
            )
        return _parse_cohort_time(text)

    def _patho_target(self, patient_id):
        row = self._cohort_row(patient_id)
        patho = 1 if row["Pathophysiology"] == "ARDS" else 0
        target = np.zeros(2, dtype=np.float32)
        target[patho] = 1
        return target

    def _breath_stream(self):
        """Yield (patient_id, breath, seq_hour) filtered to >=21 samples and
        the 24h study window (reference: deepards/dataset.py:989-1003)."""
        autoencoder = self.dataset_type in AUTOENCODER_TYPES
        for filename in self.raw_files:
            patient_id = _patient_id_from_file(filename)
            start_time = self._patient_start_time(patient_id)
            if autoencoder:
                target = np.array([np.nan, np.nan], dtype=np.float32)
            else:
                target = self._patho_target(patient_id)
            for breath in read_processed_file(filename):
                if len(breath["flow"]) < 21:
                    continue
                bt = _parse_abs_bs(breath["abs_bs"])
                if bt < start_time:
                    continue
                if bt > start_time + _STUDY_WINDOW:
                    break
                seq_hour = (bt - start_time).total_seconds() / 3600.0
                breath["_target"] = target
                yield patient_id, breath, seq_hour

    def finalize_dataset_create(self, to_pickle=None):
        if self.train:
            self.derive_scaling_factors()
        if to_pickle:
            self.save(to_pickle)
        if self.kfold_num is not None:
            self.set_kfold_indexes_for_fold(self.kfold_num)

    # -- scaling --------------------------------------------------------------

    def _scaling_for_indices(self, indices):
        """Per-channel mean/std over the given window rows
        (reference: deepards/dataset.py:627-649)."""
        obs = self.cache.data[np.asarray(indices, dtype=np.int64)]
        mu = obs.mean(axis=(0, 1, 3), dtype=np.float64)
        std = obs.std(axis=(0, 1, 3), dtype=np.float64)
        return mu.astype(np.float32), std.astype(np.float32)

    def derive_scaling_factors(self):
        if self.total_kfolds is not None:
            indices = {
                k: self.get_kfold_indexes_for_fold(k, train=True)
                for k in range(self.total_kfolds)
            }
        else:
            indices = {None: np.arange(len(self.cache))}
        self.scaling_factors = {
            k: self._scaling_for_indices(idx) for k, idx in indices.items()
        }

    # -- splits ---------------------------------------------------------------

    def _patients_by_class(self):
        y = self.cache.target.argmax(axis=1)
        pt = self.cache.patient_idx
        out = {0: [], 1: []}
        seen = set()
        # all OTHER patients, then ARDS, each in order of first window
        # (reference: deepards/dataset.py:782-786)
        for cls in (0, 1):
            for i in range(len(self.cache)):
                p = self.cache.patients[pt[i]]
                if y[i] == cls and p not in seen:
                    seen.add(p)
                    out[cls].append(p)
        return out

    def set_kfold_patient_splits(self):
        if self.kfold_patient_splits:
            return self.kfold_patient_splits
        by_class = self._patients_by_class()
        if self.bootstrap:
            self.kfold_patient_splits = sampling.bootstrap_split(
                by_class, self._rng
            )
        else:
            self.kfold_patient_splits = sampling.stratified_patient_kfold(
                by_class,
                self.total_kfolds,
                shuffle=self.random_kfold,
                seed=self.seed,
            )
        return self.kfold_patient_splits

    def _patient_per_row(self):
        return np.asarray(self.cache.patients)[self.cache.patient_idx]

    def get_kfold_indexes_for_fold(self, kfold_num, train=None):
        self.set_kfold_patient_splits()
        train = self.train if train is None else train
        key = "train" if train else "test"
        pts = self.kfold_patient_splits[kfold_num][key]
        return sampling.patients_to_indices(self._patient_per_row(), pts)

    def set_kfold_indexes_for_fold(self, kfold_num):
        self.kfold_num = kfold_num
        self.kfold_indexes = self.get_kfold_indexes_for_fold(kfold_num)
        self._handle_fractional_patients()
        # undersample before oversample (reference: deepards/dataset.py:765-772)
        self._set_undersampling_indices()
        self._set_oversampling_indices()

    def _labels_for(self, indices):
        return self.cache.target[np.asarray(indices, np.int64)].argmax(axis=1)

    def _handle_fractional_patients(self):
        if self.train_patient_fraction == 1.0 or not self.train:
            return
        if not self.total_kfolds:
            raise NotImplementedError(
                "train patient fractions only implemented for kfold"
            )
        y = self.cache.target.argmax(axis=1)
        per_row = self._patient_per_row()
        patho_per_patient = {per_row[i]: int(y[i]) for i in range(len(y))}
        self.kfold_indexes = sampling.fractional_patients(
            self.kfold_indexes,
            per_row,
            patho_per_patient,
            self.train_patient_fraction,
            self._rng,
        )

    def _set_oversampling_indices(self):
        if not self.train:
            return
        if self.oversample_minority and not self.total_kfolds:
            raise NotImplementedError(
                "oversampling not implemented for holdout sets"
            )
        if self.oversample_minority:
            self.kfold_indexes = sampling.oversample_minority(
                self.kfold_indexes,
                self._labels_for(self.kfold_indexes),
                self._rng,
            )
        if self.oversample_all_factor > 1.0:
            self.kfold_indexes = sampling.oversample_all(
                self.kfold_indexes,
                self._labels_for(self.kfold_indexes),
                self.oversample_all_factor,
                self._rng,
            )

    def set_oversampling_indices(self):
        """Public reshuffle hook (--reshuffle-oversample-per-epoch)."""
        self.kfold_indexes = self.get_kfold_indexes_for_fold(self.kfold_num)
        self._handle_fractional_patients()
        self._set_undersampling_indices()
        self._set_oversampling_indices()

    def _set_undersampling_indices(self):
        if not self.train or self.undersample_factor == -1:
            return
        self.kfold_indexes = sampling.undersample_by_homogeneity(
            self.kfold_indexes,
            self.dtw_scores,
            self.undersample_factor,
            self.undersample_std_factor,
            self._rng,
        )

    @classmethod
    def make_test_dataset_if_kfold(cls, train_dataset):
        """Test view sharing the same cache, splits and scaling factors
        (reference: deepards/dataset.py:672-704)."""
        test = cls.__new__(cls)
        test.__dict__.update(train_dataset.__dict__)
        test.train = False
        test.transforms = None
        test.oversample_minority = False
        test.oversample_all_factor = 1.0
        test.undersample_factor = -1
        test.train_patient_fraction = 1.0
        test.kfold_patient_splits = train_dataset.kfold_patient_splits
        test.scaling_factors = train_dataset.scaling_factors
        test._rng = np.random.default_rng(train_dataset.seed + 1)
        if train_dataset.kfold_num is not None:
            test.set_kfold_indexes_for_fold(train_dataset.kfold_num)
        return test

    # -- access ---------------------------------------------------------------

    def __len__(self):
        if self.kfold_num is None:
            return len(self.cache)
        return len(self.kfold_indexes)

    @property
    def n_sub_batches(self):
        return self.cache.n_sub_batches

    def current_indices(self):
        if self.kfold_num is None:
            return np.arange(len(self.cache), dtype=np.int64)
        return np.asarray(self.kfold_indexes, dtype=np.int64)

    def gather(self, absolute_indices):
        """Raw (unnormalized) rows by absolute index as a dict of dense
        arrays; normalization happens on the device."""
        idx = np.asarray(absolute_indices, dtype=np.int64)
        out = {
            "index": idx,
            "data": self.cache.data[idx],
            "target": self.cache.target[idx],
        }
        if self.cache.meta is not None:
            out["metadata"] = self.cache.meta[idx]
        return out

    def scaling_for_current_fold(self):
        if not self.scaling_factors:
            raise AttributeError(
                "Scaling factors not found for dataset. You must derive "
                "them using the `derive_scaling_factors` function."
            )
        return self.scaling_factors[self.kfold_num]

    def get_ground_truth(self):
        """Truth of the current indices, in their order (the JAX
        package's ``get_ground_truth_df`` as arrays;
        reference: deepards/dataset.py:1417-1448)."""
        idx = self.current_indices()
        return GroundTruth(
            index=idx,
            patient=self._patient_per_row()[idx],
            y=self.cache.target[idx].argmax(axis=1),
            hour=self.cache.hours[idx, 0],
        )

    def seq_hours_for(self, absolute_indices):
        return self.cache.hours[np.asarray(absolute_indices, np.int64)]

    # -- persistence ----------------------------------------------------------

    def save(self, path):
        """Array-native cache save (npz + json header), the JAX package's
        format."""
        if path.endswith(".pkl"):
            path = path[:-4] + ".npz"
        header = {
            "dataset_type": self.dataset_type,
            "experiment_num": self.experiment_num,
            "cohort_file": self.cohort_file,
            "total_kfolds": self.total_kfolds,
            "bootstrap": self.bootstrap,
            "random_kfold": self.random_kfold,
            "seed": self.seed,
            "patients": self.cache.patients,
            "frames_dropped": self.cache.frames_dropped,
            "version": 1,
        }
        arrays = {
            "data": self.cache.data,
            "target": self.cache.target,
            "hours": self.cache.hours,
            "patient_idx": self.cache.patient_idx,
        }
        if self.cache.meta is not None:
            arrays["meta"] = self.cache.meta
        np.savez_compressed(path, header=json.dumps(header), **arrays)
        return path

    @classmethod
    def from_pickle(
        cls,
        data_path,
        oversample_minority=False,
        train_patient_fraction=1.0,
        transforms=None,
        undersample_factor=-1,
        undersample_std_factor=0.2,
        oversample_all_factor=1.0,
        butter_low=None,
        butter_high=None,
        add_fft=False,
        only_fft=False,
        fft_real_only=False,
        random_kfold=False,
        bootstrap=False,
        post_hoc_downsampling=None,
        fft_filtering_low=None,
        fft_filtering_high=None,
        seed=42,
    ):
        """Load a saved dataset (the ``.npz`` format, or any other path as
        a reference pickle) and re-inject runtime arguments (reference:
        deepards/dataset.py:706-763)."""
        if data_path.endswith(".npz"):
            ds = cls._from_npz(data_path)
        else:
            ds = cls.from_reference_pickle(data_path)
        ds.oversample_minority = oversample_minority
        ds.train_patient_fraction = train_patient_fraction
        ds.transforms = transforms
        ds.undersample_factor = undersample_factor
        ds.undersample_std_factor = undersample_std_factor
        ds.oversample_all_factor = oversample_all_factor
        ds.random_kfold = random_kfold
        ds.bootstrap = bootstrap
        ds.butter_low = butter_low
        ds.butter_high = butter_high
        ds.post_hoc_downsampling = post_hoc_downsampling
        ds.fft_filtering_low = fft_filtering_low
        ds.fft_filtering_high = fft_filtering_high
        ds.seed = seed
        ds._rng = np.random.default_rng(seed)
        if bootstrap and ds.total_kfolds is None:
            ds.kfold_num = 0
            ds.total_kfolds = 1
        if ds.total_kfolds is not None or ds.bootstrap:
            ds.set_kfold_patient_splits()
        run_new_fft = (add_fft or only_fft) and not (ds.add_fft or ds.only_fft)
        ds.add_fft = add_fft
        ds.only_fft = only_fft
        ds.fft_real_only = fft_real_only
        if run_new_fft:
            perform_fft(ds.cache, add_fft, only_fft, fft_real_only)
            ds.derive_scaling_factors()
        return ds

    @classmethod
    def _from_npz(cls, path):
        with np.load(path, allow_pickle=False) as z:
            header = json.loads(str(z["header"]))
            cache = WindowCache(
                data=z["data"],
                target=z["target"],
                hours=z["hours"],
                patient_idx=z["patient_idx"],
                patients=list(header["patients"]),
                meta=z["meta"] if "meta" in z.files else None,
                frames_dropped=header.get("frames_dropped", {}),
            )
        ds = cls.__new__(cls)
        ds.cache = cache
        ds.train = True
        ds.dataset_type = header["dataset_type"]
        ds.experiment_num = header.get("experiment_num")
        ds.cohort_file = header.get("cohort_file")
        ds.total_kfolds = header.get("total_kfolds")
        ds.kfold_num = 0 if ds.total_kfolds else None
        ds.kfold_patient_splits = dict()
        ds.vent_bn_frac_missing = 0.5
        ds.whole_patient_super_batch = False
        ds.add_fft = False
        ds.only_fft = False
        ds.fft_real_only = False
        ds.drop_if_under_r2 = 0.0
        ds.drop_i_lim = False
        ds.drop_e_lim = False
        ds.truncate_e_lim = None
        ds.unpadded_downsample_factor = 4.0
        ds.dtw_scores = {}
        ds.scaling_factors = {}
        ds.seed = header.get("seed", 42)
        ds._rng = np.random.default_rng(ds.seed)
        ds.__dict__.update(_RUNTIME_DEFAULTS)
        ds.derive_scaling_factors()
        return ds

    @classmethod
    def from_reference_pickle(cls, path):
        """The reference's whole-dataset pickle (``deepards.dataset``
        objects whose ``all_sequences`` hold 4-, 5- or 6-field records),
        read without pandas or the reference package
        (``data.legacy_pickle``), as a dense cache with the pickle's
        scalar attributes (reference: deepards/dataset.py:944-968;
        SURVEY.md §7.3)."""
        obj = legacy_pickle.load(path)
        rows = []
        for seq in obj.__dict__["all_sequences"]:
            meta = None
            if len(seq) == 4:
                # a regression record's data is (1, 224)
                # (reference: deepards/dataset.py:962)
                pt, data, target, hrs = seq
            elif len(seq) == 5:
                pt, data, meta, target, hrs = seq
            elif len(seq) == 6:
                pt, data, m, mm, target, hrs = seq
                meta = np.stack([m, mm])
            else:
                raise ValueError("a record of {} fields; the reference "
                                 "writes 4, 5 or 6".format(len(seq)))
            data = np.asarray(data, dtype=np.float32)
            if data.ndim == 2:
                data = data[None]
            hrs = np.atleast_1d(np.asarray(hrs, dtype=np.float32))
            rows.append((str(pt), data, meta,
                         np.asarray(target, np.float32), list(hrs)))
        d = obj.__dict__
        ds = cls.__new__(cls)
        ds.cache = rows_to_cache(rows)
        ds.train = True
        ds.dataset_type = d.get("dataset_type")
        ds.experiment_num = d.get("experiment_num")
        ds.cohort_file = d.get("cohort_file")
        ds.total_kfolds = d.get("total_kfolds")
        ds.kfold_num = d.get("kfold_num")
        ds.kfold_patient_splits = {}
        ds.vent_bn_frac_missing = 0.5
        ds.whole_patient_super_batch = d.get("whole_patient_super_batch",
                                             False)
        ds.add_fft = d.get("add_fft", False)
        ds.only_fft = d.get("only_fft", False)
        ds.fft_real_only = d.get("fft_real_only", False)
        ds.drop_if_under_r2 = 0.0
        ds.drop_i_lim = d.get("drop_i_lim", False)
        ds.drop_e_lim = d.get("drop_e_lim", False)
        ds.truncate_e_lim = d.get("truncate_e_lim")
        ds.unpadded_downsample_factor = d.get("unpadded_downsample_factor",
                                              4.0)
        ds.dtw_scores = {}
        ds.scaling_factors = {}
        ds.seed = 42
        ds._rng = np.random.default_rng(42)
        ds.__dict__.update(_RUNTIME_DEFAULTS)
        ds.derive_scaling_factors()
        return ds
