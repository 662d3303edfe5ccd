"""Fold/epoch training loop.

Counterpart of the standard ``Trainer`` of ``deepards_tpu/train/loop.py``.
Per fold it builds a fresh, seeded model and optimizer on the device,
trains it over fixed-size batches whose pad rows carry mask 0, evaluates
the fold's test patients, and feeds the per-window predictions to the
patient votes and AUC of ``deepards_tpu_torch.eval.metrics``.

Every step goes through the fold's ``StepRunner``: on the card one train
step and one eval step captured as CUDA graphs and replayed (the JAX
package's scanned epochs), on the CPU the same steps run eagerly.  The
default epoch is the device-cache epoch: the dense window cache is
uploaded to the card once, each step gathers its batch there by index
into the runner's buffers, and the epoch's losses come back in one copy.
The host epoch (``EpochLoader`` + ``PrefetchLoader``) runs when
augmentation transforms, step checkpoints, a mid-epoch resume, ``debug``,
``stop_on_loss`` or ``device_cache: false`` ask for it; with
``fused_steps`` > 1 it gathers, augments and copies ``fused_steps``
batches at a time, and with ``stop_on_loss`` or ``debug`` one at a time.
``defer_fetch`` (default on) queues the epochs' result recording until
the fold ends, so the card never waits on the host between epochs.
Filling the runner's buffers for a step is a ``deepards.trainer.stage``
span and the queue's flush a ``deepards.records.flush`` span
(``utils.profiling``); every epoch counts its real and pad rows in
``windows.real`` and ``windows.pad``.
Randomness: numpy ``default_rng(seed)`` streams for the permutations, the
augmentation and the oversampling (those of the JAX package, drawn in its
order, so both draw the same batches and warps), a ``torch.Generator``
per fold for the init, and one per fold on the device for dropout.
A network with an LSTM carry under ``unshuffled`` (cnn_lstm) takes the
stateful fold instead: one window a step in patient order, the carry kept
across a patient's windows (``run_stateful_fold``).  A 2D network trains
on ``ImgARDSDataset`` images in host epochs, as the JAX package does: its
``gather`` normalizes, filters and augments on the host, and each step is
still a graph replay.  ``make_trainer`` also gives the parallel-fold,
ProtoPNet, detector and nested trainers.
"""
import contextlib
import os
import time

import numpy as np
import torch

from deepards_tpu_torch.data import augment
from deepards_tpu_torch.data.dataset import ARDSRawDataset
from deepards_tpu_torch.data.img_dataset import (
    ImgARDSDataset,
    image_channels,
)
from deepards_tpu_torch.data.pipeline import BatchPipeline
from deepards_tpu_torch.device import resolve_device
from deepards_tpu_torch.eval.metrics import DeepARDSResults, r2_score
from deepards_tpu_torch.models.registry import (
    get_base_network,
    get_network_spec,
    metadata_features_for,
    two_dim_base_network,
)
from deepards_tpu_torch.parallel import mesh
from deepards_tpu_torch.train import checkpoint
from deepards_tpu_torch.train import losses as loss_lib
from deepards_tpu_torch.train.loader import EpochLoader, PrefetchLoader
from deepards_tpu_torch.train.steps import (
    StepRunner,
    TrainState,
    make_optimizer,
    make_train_step,
)
from deepards_tpu_torch.utils import profiling

# the options that draw the test predictions after the folds
PLOT_OPTIONS = ("plot_untiled_disease_evol", "plot_tiled_disease_evol",
                "plot_dtw_with_disease")

_DTYPES = {"bfloat16": torch.bfloat16, "float32": None, None: None}


def _check_plotting(spec, conf):
    """Refuse ``perform_dtw_preprocessing`` and the plot options where the
    JAX package's run fails: the autoencoder, the regressor, the siamese
    and detector trainers save no predictions by hour
    (``pred_to_hour_frame`` is never set); and for the DTW frames
    (``perform_dtw_preprocessing``, ``plot_dtw_with_disease``), a 2D
    network's test split, ``ImgARDSDataset``, has no window cache, and a
    per-breath head of the standard trainer repeats each window's index S
    times, which ``process_pred_to_hour_for_dtw`` cannot expand
    (``deepards_tpu/eval/plots.py:24-37``)."""
    dtw = [k for k in ("perform_dtw_preprocessing", "plot_dtw_with_disease")
           if conf.get(k)]
    asked = dtw + [k for k in PLOT_OPTIONS[:2] if conf.get(k)]
    if not asked:
        return
    if spec.kind == "autoencoder":
        reason = "the autoencoder has no predictions by hour"
    elif spec.kind != "classifier":
        reason = "the {} trainer saves no predictions by hour".format(
            spec.kind)
    elif dtw and spec.two_dim:
        asked = dtw
        reason = "a 2D network's test split has no window cache"
    elif dtw and spec.expand_obs_idx and not spec.super_batch:
        asked = dtw
        reason = ("a per-breath head repeats each window's prediction S "
                  "times")
    else:
        return
    raise NotImplementedError(
        "{} with {}: {}, and the JAX package's run fails there".format(
            ", ".join(asked), spec.name, reason))


def make_trainer(conf, **kwargs):
    """The trainer a configuration asks for, dispatched in the JAX
    package's order (``deepards_tpu/train/loop.py:39-63``): all folds at
    once with ``parallel_folds`` for a network of the standard trainer,
    the ProtoPNet trainer for its networks, the siamese trainer for the
    twin networks (with ``parallel_folds`` too, as there), the detector
    trainer for a detector, the nested trainer for a whole-patient
    network, else ``Trainer``.  ``parallel_folds`` with a 2D network is
    refused, since its stacked folds gather from the device cache, which
    images do not use."""
    spec = get_network_spec(conf.network)
    if conf.get("parallel_folds") and spec.two_dim:
        raise NotImplementedError(
            "parallel_folds with the 2D network {}: the port stacks folds "
            "over the device cache only".format(spec.name))
    if conf.get("parallel_folds") and spec.trainer == "standard":
        from deepards_tpu_torch.train.parallel_folds import (
            ParallelFoldTrainer,
        )

        return ParallelFoldTrainer(conf, **kwargs)
    if spec.trainer == "protopnet":
        from deepards_tpu_torch.train.protopnet_trainer import (
            ProtoPNetTrainer,
        )

        return ProtoPNetTrainer(conf, **kwargs)
    if spec.trainer == "siamese":
        from deepards_tpu_torch.train.siamese_trainer import SiameseTrainer

        return SiameseTrainer(conf, **kwargs)
    if spec.kind == "detector":
        from deepards_tpu_torch.train.detector_trainer import (
            DetectorTrainer,
        )

        return DetectorTrainer(conf, **kwargs)
    if spec.super_batch:
        from deepards_tpu_torch.train.nested_trainer import NestedTrainer

        return NestedTrainer(conf, **kwargs)
    return Trainer(conf, **kwargs)


def make_stateful_steps(loss_fn, transform=None, compute_dtype=None,
                        dropout_active=True, eval_dropout_active=False):
    """(train_step, eval_step) of the stateful unshuffled fold
    (``deepards_tpu/train/loop.py:754-864``), each called as ``(state,
    data, target, mask, carry_c, carry_h, reset, meta=None)`` over one
    window: the LSTM starts from the carry buffers times ``1 - reset``
    (zero where the patient changes), and its final carry, detached, is
    written back into them.  The loss is unweighted and the norms see no
    row mask (a batch of one window has no pad row); ``mask`` is unused.
    The train step returns the loss, the eval step the loss and the (1, S,
    2) logits.  Neither reads a value back to the host, so both can be
    captured in a CUDA graph."""

    def forward(state, data, target, carry_c, carry_h, reset, meta, active):
        keep = 1 - reset
        carry = (carry_c * keep, carry_h * keep)
        if transform is not None:
            data = transform(data)
        model = state.model
        args = (not active, state.generator, meta, carry)
        if compute_dtype is not None:
            params = {name: p.to(compute_dtype)
                      for name, p in model.named_parameters()}
            logits, new_carry = torch.func.functional_call(
                model, params, (data.to(compute_dtype),) + args)
        else:
            logits, new_carry = model(data, *args)
        if compute_dtype is not None:
            logits = logits.float()
        target = target[:, None, :].expand(-1, logits.shape[1], -1)
        return loss_fn(logits, target), logits, new_carry

    def hand_on(carry_c, carry_h, new_carry):
        carry_c.copy_(new_carry[0].detach())
        carry_h.copy_(new_carry[1].detach())

    def train_step(state, data, target, mask, carry_c, carry_h, reset,
                   meta=None):
        loss, _, new_carry = forward(state, data, target, carry_c, carry_h,
                                     reset, meta, dropout_active)
        state.optimizer.zero_grad()
        loss.backward()
        state.optimizer.step()
        state.step += 1
        hand_on(carry_c, carry_h, new_carry)
        return loss.detach()

    @torch.no_grad()
    def eval_step(state, data, target, mask, carry_c, carry_h, reset,
                  meta=None):
        loss, logits, new_carry = forward(state, data, target, carry_c,
                                          carry_h, reset, meta,
                                          eval_dropout_active)
        hand_on(carry_c, carry_h, new_carry)
        return loss, logits

    return train_step, eval_step


def _pad_batch(batch, batch_size):
    """Pad a gathered batch dict up to a fixed batch size; returns mask."""
    b = batch["data"].shape[0]
    pad = batch_size - b
    mask = np.ones(batch_size, dtype=np.float32)
    if pad:
        mask[b:] = 0.0
        batch = {
            k: np.concatenate(
                [v, np.zeros((pad,) + v.shape[1:], v.dtype)], axis=0
            )
            for k, v in batch.items()
        }
    return batch, mask


def _epoch_order(idx, batch_size):
    """(steps, batch_size) window ids and row masks for an epoch over
    ``idx``: the last batch is filled by cyclic tiling (``np.resize``
    also covers a split smaller than one batch) and its pad rows get
    mask 0."""
    n = len(idx)
    steps = -(-n // batch_size)
    masks = np.ones(steps * batch_size, np.float32)
    masks[n:] = 0.0
    ids = np.resize(idx, steps * batch_size)
    return ids.reshape(steps, batch_size), masks.reshape(steps, batch_size)


def _count_windows(masks):
    """Count the real and pad rows of the 0/1 row masks ``masks`` (numpy)
    in ``windows.real`` and ``windows.pad``."""
    real = int(np.count_nonzero(masks))
    profiling.count("windows.real", real)
    profiling.count("windows.pad", masks.size - real)


def sample_shapes(dataset):
    """(shape of one sample, target width): a cache window (S, C, L), or
    an image (C, H, W)."""
    if isinstance(dataset, ImgARDSDataset):
        return dataset.data_shape, dataset.target.shape[1]
    return dataset.cache.data.shape[1:], dataset.cache.target.shape[1]


def _store(outs, i, out, steps):
    """Write step ``i``'s eval output into ``outs`` ((steps,) + its
    shape, allocated at the first step on its device)."""
    if outs is None:
        outs = out.new_empty((steps,) + tuple(out.shape))
    outs[i] = out
    return outs


def _backbone(model, option):
    """``model``'s backbone, or ValueError naming ``option`` for a network
    that has none (``metadata_only``)."""
    backbone = getattr(model, "breath_block", None)
    if backbone is None:
        raise ValueError("{}: {} has no base network".format(
            option, type(model).__name__))
    return backbone


def _chunks(iterable, size):
    """Lists of ``size`` consecutive items (the last may be shorter)."""
    chunk = []
    for item in iterable:
        chunk.append(item)
        if len(chunk) == size:
            yield chunk
            chunk = []
    if chunk:
        yield chunk


class Trainer:
    """Config-driven experiment runner (the train_and_test surface).  On
    a CUDA device its steps are CUDA-graph replays, unless its batches
    are sharded over processes (``dp_devices``, ``parallel/mesh.py``):
    then they run eagerly, each rank over its rows."""

    _DEVICE_CACHE_MAX_BYTES = 2 << 30  # larger caches take the host epoch
    # its batches are padded for the data axis and, across processes,
    # sharded (the JAX package's standard and ProtoPNet trainers); the
    # other trainers run their whole batches on every rank, as the JAX
    # package replicates them
    shards_batches = True
    # one sample's target in the runner's buffer, where it is not the
    # dataset's (target width,)
    target_shape = None

    def __init__(self, conf, device=None, verbose=True):
        self.conf = conf
        self.verbose = verbose
        if conf.get("load_siamese"):
            raise ValueError(
                "--load-siamese is read by nothing, here or in the JAX "
                "package: --load-base-network splices a siamese "
                "checkpoint's breath_block into siamese_pretrained")
        if conf.get("plot_pt_dtw_by_minute"):
            raise ValueError(
                "--plot-pt-dtw-by-minute is read by nothing, here or in "
                "the JAX package: --plot-dtw-with-disease draws the DTW "
                "over each patient's hours")
        if (conf.get("model_devices") or 1) > 1:
            raise NotImplementedError(
                "model_devices={}: the port splits no parameter over a "
                "model axis".format(conf.get("model_devices")))
        axis = mesh.make_data_axis(conf.get("dp_devices", -1) or -1)
        self.axis = axis if self.shards_batches else mesh.DataAxis()
        self.spec = get_network_spec(conf.network)
        _check_plotting(self.spec, conf)
        self.device = resolve_device(
            device if device is not None else conf.get("device"))
        self.n_kfolds = (
            1 if conf.get("bootstrap") else (conf.get("kfolds") or 1)
        )
        # every rank of a run names its results as rank 0 does
        self.start_time = mesh.broadcast_object(str(int(time.time())))
        self.results = DeepARDSResults(
            self.start_time,
            conf.get("experiment_name"),
            results_dir=conf.get("results_dir") or "results",
            conf=dict(conf.conf),
        )
        self.results.uuid_name = mesh.broadcast_object(
            self.results.uuid_name)
        self.seed = conf.get("seed", 42) or 42
        self.host_rng = np.random.default_rng(self.seed)
        self.compute_dtype = _DTYPES[conf.get("compute_dtype", "bfloat16")]
        if self.spec.kind in ("regressor", "autoencoder"):
            self.loss_fn = loss_lib.mse
        else:
            self.loss_fn = loss_lib.get_classification_loss(
                conf.get("loss_func", "bce"),
                valpha=conf.get("valpha", float("inf")) or float("inf"),
                conf_beta=conf.get("conf_beta", 1.0) or 1.0,
            )
        # the metadata input is gathered for the heads that read it
        self.meta_features = (metadata_features_for(conf.conf)
                              if self.spec.uses_metadata else 0)
        self.in_channels = 1  # the window cache's C, set with the datasets
        self._dev_caches = {}
        self._deferred = None

    # -- datasets -------------------------------------------------------------

    def _get_transforms(self):
        """Augmentation composition
        (reference: train_ards_detector.py:175-187)."""
        names = self.conf.get("transforms")
        if not names:
            return None
        return augment.build_transforms(
            names,
            self.conf.get("transform_probability", 0.2),
            use_i=bool(self.conf.get("use_i")),
        )

    def _filters(self):
        """The dataset options of the batch transforms and FFT channels."""
        conf = self.conf
        return dict(
            butter_low=conf.get("butter_low"),
            butter_high=conf.get("butter_high"),
            add_fft=bool(conf.get("with_fft")),
            only_fft=bool(conf.get("only_fft")),
            fft_real_only=bool(conf.get("fft_real_only")),
            post_hoc_downsampling=conf.get("post_hoc_downsampling"),
            fft_filtering_low=conf.get("fft_filtering_low"),
            fft_filtering_high=conf.get("fft_filtering_high"),
        )

    def get_base_datasets(self):
        """(reference: train_ards_detector.py:189-315)"""
        conf = self.conf
        seed = self.seed
        kfold_num = None if not conf.get("kfolds") else 0
        common = dict(
            oversample_minority=bool(conf.get("oversample_minority")),
            train_patient_fraction=conf.get("train_pt_frac", 1.0),
            transforms=self._get_transforms(),
            undersample_factor=conf.get("undersample_factor", -1),
            undersample_std_factor=conf.get("undersample_std_factor", 0.2),
            oversample_all_factor=conf.get("oversample_all_factor", 1.0),
            random_kfold=bool(conf.get("random_kfold")),
            bootstrap=bool(conf.get("bootstrap")),
            seed=seed,
            **self._filters(),
        )
        if conf.get("train_from_pickle"):
            train_dataset = ARDSRawDataset.from_pickle(
                conf.train_from_pickle, **common)
        else:
            train_dataset = ARDSRawDataset(
                conf.data_path,
                conf.experiment_num,
                conf.cohort_file,
                conf.n_sub_batches,
                dataset_type=conf.dataset_type,
                to_pickle=conf.get("train_to_pickle"),
                kfold_num=kfold_num,
                total_kfolds=conf.get("kfolds"),
                unpadded_downsample_factor=conf.get("downsample_factor", 4.0),
                holdout_set_type=conf.get("holdout_set_type", "main"),
                drop_if_under_r2=conf.get("drop_if_under_r2", 0) or 0,
                drop_i_lim=bool(conf.get("drop_i_lim")),
                drop_e_lim=bool(conf.get("drop_e_lim")),
                truncate_e_lim=conf.get("truncate_e_lim"),
                **common,
            )
        self.n_sub_batches = train_dataset.n_sub_batches
        self.in_channels = train_dataset.cache.data.shape[2]

        if conf.get("kfolds"):
            test_dataset = ARDSRawDataset.make_test_dataset_if_kfold(
                train_dataset
            )
        elif conf.get("test_from_pickle"):
            test_dataset = ARDSRawDataset.from_pickle(conf.test_from_pickle)
            test_dataset.train = False
        else:
            test_dataset = ARDSRawDataset(
                conf.data_path,
                conf.experiment_num,
                conf.cohort_file,
                conf.n_sub_batches,
                dataset_type=conf.dataset_type,
                to_pickle=conf.get("test_to_pickle"),
                train=False,
                unpadded_downsample_factor=conf.get("downsample_factor", 4.0),
                holdout_set_type=conf.get("holdout_set_type", "main"),
                final_validation_set=bool(conf.get("final_validation")),
                drop_i_lim=bool(conf.get("drop_i_lim")),
                drop_e_lim=bool(conf.get("drop_e_lim")),
                truncate_e_lim=conf.get("truncate_e_lim"),
                seed=seed,
                **self._filters(),
            )
        test_dataset.scaling_factors = train_dataset.scaling_factors
        if self.spec.two_dim:
            return self.image_datasets(train_dataset, test_dataset)
        return train_dataset, test_dataset

    def image_options(self):
        """The ``ImgARDSDataset`` options both splits share: the FFT
        channels, the Butterworth filter (``butter_freq``) and a
        detector's bbox splices.  Names the backbone with its 2D suffix
        (reference: train_ards_detector.py:111-116, 309-313) and sets
        ``in_channels`` to the images' C."""
        conf = self.conf
        conf.conf["base_network"] = two_dim_base_network(
            self.spec, conf.get("base_network", "densenet18"))
        fft = dict(add_fft=bool(conf.get("with_fft")),
                   fft_only=bool(conf.get("only_fft")),
                   fft_real_only=bool(conf.get("fft_real_only")))
        self.in_channels = image_channels(**fft)
        return dict(fft, butter_filter=conf.get("butter_freq"),
                    bbox=self.spec.kind == "detector")

    def image_datasets(self, train_raw, test_raw):
        """The splits as ``ImgARDSDataset`` images of ``image_options``.
        Both splits get the FFT channels and the Butterworth filter: the
        JAX package gives the test split neither
        (``deepards_tpu/train/loop.py:259-263``), so there a network
        trained on three channels is evaluated on three copies of the flow
        image.  Only the train split gets the 2D transforms and the patho
        mix (``row_mix``); both get the bbox splices for a detector.
        ``reload_dataset_per_epoch`` is read by nothing, as in the JAX
        package."""
        conf = self.conf
        options = self.image_options()
        train = ImgARDSDataset(
            train_raw, extra_transforms=conf.get("two_dim_transforms") or [],
            same_patho_mix=bool(conf.get("row_mix")), seed=self.seed,
            **options)
        test = ImgARDSDataset(test_raw, seed=self.seed + 1, **options)
        test.scaling_factors = train.scaling_factors
        return train, test

    # -- model ----------------------------------------------------------------

    def _fold_seed(self, fold_num, stream):
        """A 32-bit seed for one fold's ``stream`` (0 init, 1 dropout)."""
        return int(np.random.SeedSequence(
            [self.seed, fold_num, stream]).generate_state(1)[0])

    def build_model(self):
        conf = self.conf.conf
        return self.spec.build(
            conf, get_base_network(conf, self.in_channels),
            self.n_sub_batches, self.meta_features)

    def init_model(self, model, fold_num):
        """The fold's seeded initialization, drawn on the CPU (so the card
        and the CPU start from the same params)."""
        model.reset_parameters(
            torch.Generator().manual_seed(self._fold_seed(fold_num, 0)))

    def new_state(self, fold_num):
        """A fresh model, optimizer and dropout generator for a fold.  With
        ``freeze_base_network`` the backbone takes no gradient and stays
        out of the optimizer: no update, no weight decay
        (reference: train_ards_detector.py:411-413)."""
        conf = self.conf
        model = self.build_model()
        self.init_model(model, fold_num)
        model.to(self.device)
        if conf.get("freeze_base_network"):
            _backbone(model, "--freeze-base-network").requires_grad_(False)
        optimizer = make_optimizer(
            [p for p in model.parameters() if p.requires_grad],
            optimizer=conf.get("optimizer", "sgd"),
            learning_rate=conf.get("learning_rate", 0.001),
            weight_decay=conf.get("weight_decay", 0.0001),
            clip_grad=bool(conf.get("clip_grad")),
            clip_val=conf.get("clip_val", 0.01),
        )
        generator = torch.Generator(device=self.device).manual_seed(
            self._fold_seed(fold_num, 1))
        return TrainState(model, optimizer, generator)

    def restore_state(self, state, path):
        """Full state (params, optimizer, generator, step) from a
        checkpoint of ``save_checkpoint``."""
        saved = checkpoint.restore(path)
        state.model.load_state_dict(saved["params"])
        if "opt_state" in saved:
            state.optimizer.load_state_dict(saved["opt_state"])
        if "rng" in saved:
            state.generator.set_state(saved["rng"])
        state.step = saved.get("step", 0)
        return state

    def load_base_network(self, state, path):
        """Splice the backbone (``breath_block.*``) of a port checkpoint, or
        of an ``.npz`` of the JAX package's flat params, into the fold's
        model (reference: train_ards_detector.py:383-388)."""
        _backbone(state.model, "--load-base-network")
        params = checkpoint.restore(path)["params"]
        backbone = {k: v for k, v in params.items()
                    if k.startswith("breath_block.")}
        if not backbone:
            raise ValueError("{} holds no breath_block params".format(path))
        state.model.load_state_dict(backbone, strict=False)
        return state

    # -- main loop ------------------------------------------------------------

    def train_and_test(self):
        """Every fold.  With ``load_checkpoint`` each fold starts from that
        state; a checkpoint saved after an epoch or after a step (its
        ``.resume.json`` names the fold, the epoch, the next batch, the
        epoch's order and the host generator's state) resumes there, and
        the rest of the run equals the run that saved it."""
        conf = self.conf
        self.resume_meta = None
        if conf.get("load_checkpoint"):
            self.resume_meta = checkpoint.load_resume_meta(
                conf.load_checkpoint)
        if self.resume_meta and "host_rng" in self.resume_meta:
            self.host_rng.bit_generator.state = self.resume_meta["host_rng"]
        train_dataset, test_dataset = self.get_base_datasets()
        for fold_num in range(self.n_kfolds):
            if conf.get("only_fold") is not None and fold_num != conf.only_fold:
                continue
            if conf.get("kfolds") or conf.get("bootstrap"):
                if self.verbose:
                    print("--- Run Fold {} ---".format(fold_num + 1))
                # before a fold is skipped too: its oversampling draws
                # keep the later folds' windows those of the whole run
                train_dataset.set_kfold_indexes_for_fold(fold_num)
                test_dataset.set_kfold_indexes_for_fold(fold_num)
            if self.resume_meta and fold_num < self.resume_meta["fold"]:
                continue  # fold completed before the checkpoint
            # the fold's scaling goes into the checkpoint sidecars, so
            # serving normalizes without the dataset
            self._current_scaling = train_dataset.scaling_for_current_fold()
            self.run_fold(fold_num, train_dataset, test_dataset)
        self.perform_post_modeling_actions()
        self.perform_plotting(test_dataset)
        return self.results

    def perform_plotting(self, test_dataset):
        """After the folds (reference: train_ards_detector.py:496-511):
        with ``perform_dtw_preprocessing`` or ``plot_dtw_with_disease``,
        each patient's rolling DTW frame of the last predictions by hour
        on the last fold's test split, cached under ``dtw_cache`` and kept
        as ``dtw_frames`` ({patient: ``DTWFrame``}); then with
        ``plot_tiled_disease_evol`` the tiled TP/TN/FP/FN grids under
        ``prediction_plots/tiled_*``, else with any plot option one
        hourly plot a patient under ``prediction_plots`` (the DTW over it
        with ``plot_dtw_with_disease``), each an ``.npz`` and, on the CPU
        host with matplotlib, a PNG.  In a run over processes rank 0
        writes them."""
        conf = self.conf
        wants_dtw = (conf.get("plot_dtw_with_disease")
                     or conf.get("perform_dtw_preprocessing"))
        wants_plots = any(conf.get(k) for k in PLOT_OPTIONS)
        if not (wants_dtw or wants_plots) or mesh.process_index():
            return
        from deepards_tpu_torch.eval import plots

        dtw_frames = None
        if wants_dtw:
            self.dtw_frames = dtw_frames = plots.perform_dtw_preprocessing(
                self.results, test_dataset, "dtw_cache", device=self.device)
        if conf.get("plot_tiled_disease_evol"):
            plots.plot_tiled_disease_evol(
                self.results, "prediction_plots/tiled.png",
                device=self.device)
        elif wants_plots:
            plots.perform_hourly_patient_plot(
                self.results, dtw_frames=dtw_frames, device=self.device)

    def make_runner(self, state, dataset, train_step, eval_step,
                    graphed=None):
        """The fold's ``StepRunner`` for this process's rows of the padded
        batches (``batch_rows``) of ``dataset``'s windows or images, its
        target buffer of ``target_shape`` where that is set: its graphs
        are captured here, after the fold's state is final (on the card,
        unless ``graphed`` is False or the batches are sharded over
        processes)."""
        batch_size = self.batch_rows()[1]
        meta_shape = None
        if self.meta_features:
            meta_shape = (batch_size,) + dataset.cache.meta.shape[1:]
        data_shape, target_width = sample_shapes(dataset)
        extra = None
        if self.target_shape is not None:
            extra = {"target": torch.zeros(
                (batch_size,) + self.target_shape, device=self.device)}
        if graphed is None:
            graphed = self.device.type == "cuda" and not self.axis.sharded
        return StepRunner(state, train_step, eval_step,
                          (batch_size,) + data_shape,
                          target_width=target_width, meta_shape=meta_shape,
                          graphed=graphed, extra_inputs=extra,
                          axis=self.axis)

    def batch_rows(self):
        """(the padded batch: ``batch_size`` up to a multiple of the data
        axis, the number of its rows this process holds)."""
        target = self.axis.pad_target(self.conf.get("batch_size", 16))
        rows = self.axis.local(target)
        return target, rows.stop - rows.start

    def step_options(self, dataset):
        """``make_train_step``'s options for this network over the train
        split ``dataset``: its batch transforms on the device, or none for
        images (``gather`` normalizes them), and the norms' rows, the B*S
        windows or the B images."""
        two_dim = self.spec.two_dim
        return dict(
            transform=None if two_dim else BatchPipeline(dataset,
                                                         self.device),
            compute_dtype=self.compute_dtype,
            eval_dropout_active=not self.spec.eval_dropout_off,
            target_mode=self.spec.target_mode,
            bn_mask_rows="batch" if two_dim else "windows")

    def fold_state(self, fold_num):
        """``new_state``, then the checkpoint or the base network the
        configuration loads."""
        conf = self.conf
        state = self.new_state(fold_num)
        if conf.get("load_checkpoint"):
            self.restore_state(state, conf.load_checkpoint)
        if conf.get("load_base_network"):
            self.load_base_network(state, conf.load_base_network)
        mesh.replicate_tree(state.model.parameters())
        return state

    def sample_draws(self, dataset):
        """The JAX package's trainers gather two images of the train split
        at each fold's start to initialize the model, which draws their 2D
        transforms from the dataset's generator: the port gathers them too
        (and drops them), so that both draw the same images after."""
        if self.spec.two_dim:
            dataset.gather(dataset.current_indices()[:2])

    def run_fold(self, fold_num, train_dataset, test_dataset):
        conf = self.conf
        self.last_train_count = len(train_dataset.current_indices())
        self.last_test_count = len(test_dataset.current_indices())
        self.sample_draws(train_dataset)
        state = self.fold_state(fold_num)
        if self.spec.stateful_lstm and conf.get("unshuffled"):
            return self.run_stateful_fold(state, train_dataset, test_dataset,
                                          fold_num)
        train_step, eval_step = make_train_step(
            self.loss_fn, **self.step_options(train_dataset))
        runner = self.make_runner(state, train_dataset, train_step,
                                  eval_step)
        epochs = conf.get("epochs", 10)
        resume = self.resume_meta
        if not (resume and resume["fold"] == fold_num):
            resume = None
        start_epoch = resume["epoch"] if resume else 1
        with self.deferred_fetch():
            for epoch_num in range(start_epoch, epochs + 1):
                mid_epoch = (resume if resume and resume["epoch"] == epoch_num
                             and resume.get("next_batch") else None)
                if not conf.get("no_train"):
                    self.run_train_epoch(runner, train_dataset, fold_num,
                                         epoch_num, resume=mid_epoch)
                if conf.get("reshuffle_oversample_per_epoch"):
                    train_dataset.set_oversampling_indices()
                if not conf.get("no_test_after_epochs") or epoch_num == epochs:
                    self.run_test_epoch(runner, test_dataset, fold_num,
                                        epoch_num)
                if conf.get("save_model_per_epoch") and conf.get("save_model"):
                    self.save_checkpoint(state, fold_num, epoch_num)
        if conf.get("save_model"):
            self.save_checkpoint(state, fold_num, None)
        if resume:
            self.resume_meta = None  # later folds run from scratch
        self.final_state = state
        return state

    # -- the stateful unshuffled fold ----------------------------------------

    def make_stateful_runner(self, state, dataset, dropout=True,
                             graphed=None):
        """A ``StepRunner`` of ``make_stateful_steps`` over batches of one
        window, with the carry buffers (c, h) and the reset flag: float32
        as the JAX package's zero carry, float64 for a float64 model.
        ``dropout`` False turns it off in training too; ``graphed`` None
        captures on the card."""
        train_step, eval_step = make_stateful_steps(
            self.loss_fn, transform=BatchPipeline(dataset, self.device),
            compute_dtype=self.compute_dtype, dropout_active=dropout,
            eval_dropout_active=dropout and not self.spec.eval_dropout_off)
        model = state.model
        cache = dataset.cache
        dtype = torch.promote_types(next(model.parameters()).dtype,
                                    torch.float32)
        carry = (1, model.lstm.hidden_size)
        extra = {"carry_c": torch.zeros(carry, dtype=dtype,
                                        device=self.device),
                 "carry_h": torch.zeros(carry, dtype=dtype,
                                        device=self.device),
                 "reset": torch.ones(1, device=self.device)}
        meta_shape = None
        if self.meta_features:
            meta_shape = (1,) + cache.meta.shape[1:]
        if graphed is None:
            graphed = self.device.type == "cuda"
        return StepRunner(state, train_step, eval_step,
                          (1,) + cache.data.shape[1:],
                          target_width=cache.target.shape[1],
                          meta_shape=meta_shape, graphed=graphed,
                          extra_inputs=extra)

    def run_stateful_fold(self, state, train_dataset, test_dataset,
                          fold_num):
        """cnn_lstm with ``unshuffled``: every epoch visits the windows one
        at a time in the ground truth's (patient) order, the LSTM carry
        kept across a patient's windows and reset where the patient
        changes (``deepards_tpu/train/loop.py:754-987``).  Train losses go
        to the loss meter, test losses to ``test_loss``, and each window's
        S per-breath predictions to the votes."""
        conf = self.conf
        runner = self.make_stateful_runner(state, train_dataset)
        epochs = conf.get("epochs", 10)
        resume = self.resume_meta
        if not (resume and resume["fold"] == fold_num):
            resume = None
        start_epoch = resume["epoch"] if resume else 1
        with self.deferred_fetch():
            for epoch_num in range(start_epoch, epochs + 1):
                if not conf.get("no_train"):
                    self.run_stateful_epoch(runner, train_dataset, True,
                                            fold_num, epoch_num)
                if not conf.get("no_test_after_epochs") or epoch_num == epochs:
                    self.run_stateful_epoch(runner, test_dataset, False,
                                            fold_num, epoch_num)
                if conf.get("save_model_per_epoch") and conf.get("save_model"):
                    self.save_checkpoint(state, fold_num, epoch_num)
        if conf.get("save_model"):
            self.save_checkpoint(state, fold_num, None)
        if resume:
            self.resume_meta = None
        self.final_state = state
        return state

    def run_stateful_epoch(self, runner, dataset, train, fold_num,
                           epoch_num):
        """One pass over ``dataset``'s windows in the ground truth's order
        (one window with ``debug``), each gathered on the device into the
        runner's buffers with its reset flag: 1 at the first window and
        where the patient changes."""
        truth = dataset.get_ground_truth()
        order = np.asarray(truth.index)
        resets = np.ones(len(order), np.float32)
        resets[1:] = truth.patient[1:] != truth.patient[:-1]
        if self.conf.get("debug"):
            order, resets = order[:1], resets[:1]
        dev = self._get_device_cache(dataset)
        ids = torch.from_numpy(order).to(self.device)
        resets = torch.from_numpy(resets).to(self.device)
        inputs = runner.inputs
        losses = outs = None
        for i in range(len(order)):
            for key, table in dev.items():
                torch.index_select(table, 0, ids[i:i + 1], out=inputs[key])
            inputs["reset"].copy_(resets[i:i + 1])
            if train:
                losses = _store(losses, i, runner.train(), len(order))
            else:
                loss, out = runner.eval()
                losses = _store(losses, i, loss, len(order))
                outs = _store(outs, i, out[0], len(order))
        if losses is None:
            return
        if train:
            self._defer(self._record_stateful_losses, losses, "loss",
                        fold_num)
            return
        self._defer(self._record_stateful_losses, losses, "test_loss",
                    fold_num)
        self._defer(self._record_stateful_eval, outs, order, dataset,
                    fold_num, epoch_num)

    def _record_stateful_losses(self, losses, meter, fold_num):
        for loss in losses.cpu().numpy():
            self.results.update_meter(meter, fold_num, float(loss))

    def _record_stateful_eval(self, outs, order, dataset, fold_num,
                              epoch_num):
        """Each window's S per-breath predictions, its index repeated S
        times."""
        outs = outs.cpu().numpy()  # (n, S, 2)
        self.last_eval = {"index": order, "logits": outs}
        preds = outs.argmax(axis=-1).reshape(-1)
        self.record_classifier_results(
            preds, np.repeat(order, outs.shape[1]), dataset, fold_num,
            epoch_num)

    # -- deferred recording ---------------------------------------------------

    @contextlib.contextmanager
    def deferred_fetch(self):
        """While armed, the epochs queue their result recording (the
        losses' and logits' copy to the host, votes, AUC) with ``_defer``
        instead of waiting on the card, and the queue runs when the fold
        ends (or before a checkpoint).  The records are the same; only
        the time the host reads them moves.  ``defer_fetch: false``
        records each epoch as it ends."""
        self._deferred = [] if self.conf.get("defer_fetch", True) else None
        try:
            yield
            self._flush_deferred()
        finally:
            self._deferred = None

    def _defer(self, fn, *args):
        if self._deferred is None:
            fn(*args)
        else:
            self._deferred.append(lambda: fn(*args))

    def _flush_deferred(self):
        if not self._deferred:
            return
        with profiling.annotate("deepards.records.flush"):
            while self._deferred:
                self._deferred.pop(0)()

    # -- train epochs ---------------------------------------------------------

    def _device_cache_eligible(self, dataset, resume=None):
        """The default epoch: eligible when nothing needs the host inside
        the epoch (no augmentation, no step checkpoints or mid-epoch
        resume, no stop-on-loss breaker, no debug single batch) and the
        cache fits, unless ``device_cache`` says otherwise.  Images take
        host epochs, as in the JAX package."""
        conf = self.conf
        flag = conf.get("device_cache")
        if flag is False or self.spec.two_dim:
            return False
        if callable(getattr(dataset, "transforms", None)):
            return False
        if resume is not None or conf.get("checkpoint_every_n_steps"):
            return False
        if conf.get("stop_on_loss") or conf.get("debug"):
            return False
        if flag is not True and (dataset.cache.data.nbytes
                                 > self._DEVICE_CACHE_MAX_BYTES):
            return False
        return True

    def _get_device_cache(self, dataset):
        """The cache's data, targets and (for a head that reads it)
        metadata on the device, uploaded once per ``cache.token``: the
        k-fold train and test views share one."""
        key = dataset.cache.token
        if key not in self._dev_caches:
            arrays = {"data": dataset.cache.data,
                      "target": dataset.cache.target}
            if self.meta_features:
                arrays["meta"] = dataset.cache.meta
            self._dev_caches[key] = {
                k: torch.from_numpy(v).to(self.device)
                for k, v in arrays.items()}
        return self._dev_caches[key]

    def _device_steps(self, runner, dataset, ids, masks, train):
        """One step per row of ``ids`` over the device cache, each batch
        (this process's columns of ``ids``) gathered into the runner's
        buffers on the device.  Returns the (steps,) losses (``(steps,) +
        shape`` of what a train step returns) and, for eval, the (steps,
        B, ...) outputs of this process's rows, on the device."""
        dev = self._get_device_cache(dataset)
        rows = self.axis.local(ids.shape[1])
        _count_windows(masks[:, rows])
        ids = torch.from_numpy(np.ascontiguousarray(ids[:, rows])).to(
            self.device)
        masks = torch.from_numpy(np.ascontiguousarray(masks[:, rows])).to(
            self.device)
        steps = ids.shape[0]
        losses = outs = None
        inputs = runner.inputs
        for i in range(steps):
            with profiling.annotate("deepards.trainer.stage"):
                for key, table in dev.items():
                    torch.index_select(table, 0, ids[i], out=inputs[key])
                inputs["mask"].copy_(masks[i])
            if train:
                losses = _store(losses, i, runner.train(), steps)
            else:
                loss, out = runner.eval()
                losses = _store(losses, i, loss, steps)
                outs = _store(outs, i, out, steps)
        if losses is None:  # an empty split
            losses = torch.empty(0, device=self.device)
        return losses, outs

    def _host_steps(self, runner, batches, steps, train=True):
        """One step per batch of ``batches`` (dicts of the runner's inputs
        on the device, prepared on the host by a ``PrefetchLoader`` thread
        ahead of the card), each copied into the runner's buffers.
        Returns the losses and, for eval, the outputs, as
        ``_device_steps`` stores them (None for no batch)."""
        losses = outs = None
        for i, batch in enumerate(batches):
            with profiling.annotate("deepards.trainer.stage"):
                for key, value in batch.items():
                    runner.inputs[key].copy_(value)
            if train:
                losses = _store(losses, i, runner.train(), steps)
            else:
                loss, out = runner.eval()
                losses = _store(losses, i, loss, steps)
                outs = _store(outs, i, out, steps)
        return losses, outs

    def _run_train_epoch_device_cache(self, runner, dataset, fold_num,
                                      epoch_num):
        conf = self.conf
        idx = np.asarray(dataset.current_indices())
        perm = idx if conf.get("unshuffled") else self.host_rng.permutation(
            idx)
        ids, masks = _epoch_order(perm, self.batch_rows()[0])
        if self.verbose:
            print("train instances: {} (device-cache epoch)".format(
                len(ids)))
        losses, _ = self._device_steps(runner, dataset, ids, masks, True)
        self._defer(self._record_train_losses, losses, fold_num, epoch_num)

    def _record_train_losses(self, losses, fold_num, epoch_num):
        for loss in losses.cpu().numpy():
            self.results.update_meter(
                "loss_epoch_{}".format(epoch_num), fold_num, float(loss))
            self.results.update_loss(fold_num, float(loss))

    def step_arrays(self, batch, batch_size):
        """What the steps read of a gathered batch, padded to
        ``batch_size``: {data, target, mask[, meta]}, of which a process
        of a sharded run keeps its rows (``mesh.shard_batch``)."""
        batch, mask = _pad_batch(batch, batch_size)
        out = {"data": batch["data"], "target": batch["target"],
               "mask": mask}
        if self.meta_features:
            out["meta"] = batch["metadata"]
        if self.axis.sharded:
            out = mesh.shard_batch(self.axis, out)[0]
        return out

    def device_batch(self, batch, batch_size):
        """``step_arrays`` on the device."""
        return {k: torch.from_numpy(v).to(self.device)
                for k, v in self.step_arrays(batch, batch_size).items()}

    def _count_host_epoch(self, loader, target):
        """Count the real and pad rows of this process's share of a host
        epoch, ``loader``'s batches each padded to ``target`` rows, once
        an epoch as ``_device_steps`` does (an epoch cut short by
        ``debug`` or ``stop_on_loss`` counts all of its batches)."""
        masks = np.arange(target) < loader.batch_sizes()[:, None]
        _count_windows(masks[:, self.axis.local(target)])

    def run_train_epoch(self, runner, dataset, fold_num, epoch_num,
                        resume=None):
        """The device-cache epoch where eligible, else a host epoch.  With
        ``checkpoint_every_n_steps`` the epoch's order is drawn first and
        saved with each step checkpoint; ``resume`` (a step checkpoint's
        meta) replays that order from its next batch."""
        conf = self.conf
        ckpt_every = conf.get("checkpoint_every_n_steps") or 0
        perm, start_batch = None, 0
        if resume is not None:
            perm, start_batch = resume["perm"], resume["next_batch"]
        elif ckpt_every:
            idx = np.asarray(dataset.current_indices())
            perm = (idx if conf.get("unshuffled")
                    else self.host_rng.permutation(idx))
        if self._device_cache_eligible(dataset, resume):
            return self._run_train_epoch_device_cache(
                runner, dataset, fold_num, epoch_num)
        batch_size = conf.get("batch_size", 16)
        loader = EpochLoader(dataset, batch_size,
                             shuffle=not conf.get("unshuffled"),
                             rng=self.host_rng, indices=perm,
                             start_batch=start_batch)
        # augmentation draws from host_rng after the permutation, batch by
        # batch, in the JAX package's order; the generator's state after
        # each batch rides along for the step checkpoints
        transforms = dataset.transforms if callable(
            getattr(dataset, "transforms", None)) else None

        target = self.batch_rows()[0]

        def prepare(batches):
            out = []
            for batch in batches:
                if transforms is not None:
                    batch["data"] = augment.apply_to_batch(
                        transforms, batch["data"], self.host_rng)
                out.append(self.step_arrays(batch, target))
            dev = {k: torch.from_numpy(np.stack([b[k] for b in out])).to(
                self.device) for k in out[0]}
            return dev, self.host_rng.bit_generator.state

        single = conf.get("stop_on_loss") or conf.get("debug")
        fused = 1 if single else max(conf.get("fused_steps") or 1, 1)
        if self.verbose:
            print("train instances: {}{}".format(
                len(loader), " (fused x{})".format(fused) if fused > 1
                else ""))
        losses = torch.empty(len(loader), device=self.device)
        self._count_host_epoch(loader, target)
        n = 0  # steps run in this call
        last_ckpt = start_batch
        for chunk, rng_state in PrefetchLoader(_chunks(loader, fused),
                                               map_fn=prepare):
            # the runner's buffers are written here, on the main thread
            steps = chunk["data"].shape[0]
            for j in range(steps):
                with profiling.annotate("deepards.trainer.stage"):
                    for key, value in chunk.items():
                        runner.inputs[key].copy_(value[j])
                losses[n] = runner.train()
                n += 1
                # the loss of step N is read after step N+1 is queued, so
                # the stop-on-loss breaker fires one step late, as in the
                # JAX package
                if single and n > 1 and self._record(
                        losses[n - 2], fold_num, epoch_num):
                    return
            done = start_batch + n
            if ckpt_every and steps == fused and (
                    done - last_ckpt >= ckpt_every):
                # step checkpoints land at the ends of chunks
                self.save_checkpoint(
                    runner.state, fold_num, epoch_num, step=done,
                    resume_meta={
                        "fold": fold_num, "epoch": epoch_num,
                        "next_batch": done, "perm": perm,
                        "host_rng": rng_state,
                    })
                last_ckpt = done
            if conf.get("debug"):
                break
        if single:
            if n:
                self._record(losses[n - 1], fold_num, epoch_num)
        else:
            self._defer(self._record_train_losses, losses[:n], fold_num,
                        epoch_num)

    def _record(self, loss, fold_num, epoch_num):
        """Record one step's loss; True when the stop-on-loss breaker
        fires."""
        conf = self.conf
        loss = float(loss)
        self.results.update_meter(
            "loss_epoch_{}".format(epoch_num), fold_num, loss)
        self.results.update_loss(fold_num, loss)
        if (conf.get("stop_on_loss")
                and loss > conf.get("stop_thresh", 1.5)
                and epoch_num > conf.get("stop_after_epoch", 1)):
            print("stop on loss: loss={:.4f} exceeded stop_thresh".format(
                loss))
            return True
        return False

    # -- test epochs ----------------------------------------------------------

    def run_test_epoch(self, runner, dataset, fold_num, epoch_num):
        """The device-cache epoch visits ``idx`` in padded batches, the
        host epoch in batches of the batch size, each padded; the pad rows
        of every batch are dropped from the outputs, which are gathered
        from every process first (``mesh.fetch_global``)."""
        batch_size = self.conf.get("batch_size", 16)
        target = self.batch_rows()[0]
        idx = np.asarray(dataset.current_indices())
        if self._device_cache_eligible(dataset):
            ids, masks = _epoch_order(idx, target)
            real = target
            losses, outs = self._device_steps(runner, dataset, ids, masks,
                                              False)
        else:
            loader = EpochLoader(dataset, batch_size, shuffle=False)
            real = batch_size
            self._count_host_epoch(loader, target)
            losses, outs = self._host_steps(runner, PrefetchLoader(
                loader, map_fn=lambda b: self.device_batch(b, target)),
                len(loader), train=False)
        if losses is None:
            # an empty split (a bootstrap run's test split can be): no
            # losses, and a classifier records no predictions, as in the
            # JAX package
            shape = ((0, self.n_sub_batches, 2) if self.spec.expand_obs_idx
                     else (0, 2))
            self._defer(lambda: self._record_eval(
                np.zeros(0, np.float32), np.zeros(shape, np.float32), idx,
                dataset, fold_num, epoch_num))
            return
        # both paths visit idx in order, ``real`` rows a batch
        self._defer(lambda: self._record_eval(
            losses.cpu().numpy(),
            mesh.fetch_global(self.axis, outs, 1)[:, :real].reshape(
                (-1,) + tuple(outs.shape[2:]))[:len(idx)],
            idx, dataset, fold_num, epoch_num))

    def _record_eval(self, losses, outs, idx, dataset, fold_num, epoch_num):
        """Test losses per step, then the per-window outputs ``outs`` of
        the windows ``idx``: a classifier's (n, 2) logits, or (n, S, 2)
        for a per-breath head, whose every window index then repeats S
        times; a regressor's (n, T) predictions
        (reference: deepards_tpu/train/loop.py:1250-1271)."""
        for loss in losses:
            self.results.update_meter("test_loss", fold_num, float(loss))
            self.results.update_epoch_meter("test_loss", epoch_num,
                                            float(loss))
        self.last_eval = {"index": idx, "logits": outs}
        if self.spec.kind == "autoencoder":
            return  # its record is the test losses alone, as in JAX
        if self.spec.kind == "regressor":
            self.record_regressor_results(outs, dataset.cache.target[idx],
                                          fold_num)
            return
        preds = outs.argmax(axis=-1)
        pred_idx = idx
        if self.spec.expand_obs_idx:
            pred_idx = np.repeat(idx, preds.shape[1])
            preds = preds.reshape(-1)
        self.record_classifier_results(preds, pred_idx, dataset, fold_num,
                                       epoch_num)

    def record_classifier_results(self, preds, pred_idx, dataset, fold_num,
                                  epoch_num):
        """Predictions sorted by window index, then patient votes and
        predictions by hour (reference: train_ards_detector.py:519-524)."""
        order = np.argsort(pred_idx, kind="stable")
        pred_idx = np.asarray(pred_idx)[order]
        preds = np.asarray(preds)[order]
        truth = dataset.get_ground_truth()
        self.results.perform_patient_predictions(
            truth, pred_idx, preds, fold_num, epoch_num,
            verbose=self.verbose)
        seq_hours = {int(i): np.atleast_1d(dataset.seq_hours_for([int(i)])[0])
                     for i in truth.index}
        self.results.save_predictions_by_hour(
            truth, pred_idx, preds, seq_hours, epoch_num, fold_num)

    def record_regressor_results(self, preds, targets, fold_num):
        """Test MAE, MSE and r2 of a fold's predictions
        (reference: train_ards_detector.py:661-679)."""
        self.results.update_meter(
            "test_mae", fold_num, float(np.abs(preds - targets).mean()))
        self.results.update_meter(
            "test_mse", fold_num, float(((preds - targets) ** 2).mean()))
        self.results.update_r2(fold_num, r2_score(targets, preds))

    def perform_post_modeling_actions(self):
        if self.spec.kind == "classifier":
            self.results.aggregate_classification_results(
                verbose=self.verbose)
        self.results.save_all()

    # -- checkpointing --------------------------------------------------------

    def save_checkpoint(self, state, fold_num, epoch_num, step=None,
                        resume_meta=None):
        """``<saved_models_dir>/<name>[-epochN][-foldK][-stepN]`` with its
        scaling and configuration sidecars.  After an epoch the resume
        point is this fold's next epoch; a step checkpoint passes its own
        (``resume_meta``).  Recording queued by ``deferred_fetch`` runs
        first.  In a run over processes rank 0 writes it."""
        self._flush_deferred()
        base = self.conf.get("save_model") or "model"
        name = os.path.splitext(os.path.basename(base))[0]
        if epoch_num is not None:
            name += "-epoch{}".format(epoch_num)
        if self.n_kfolds > 1:
            name += "-fold{}".format(fold_num)
        if step is not None:
            name += "-step{}".format(step)
        if epoch_num is not None and resume_meta is None:
            resume_meta = {"fold": fold_num, "epoch": epoch_num + 1,
                           "next_batch": 0,
                           "host_rng": self.host_rng.bit_generator.state}
        out_dir = self.conf.get("saved_models_dir") or "saved_models"
        path = os.path.join(out_dir, name)
        if mesh.process_index():
            # the ranks hold one state: rank 0 writes it
            return os.path.abspath(path)
        os.makedirs(out_dir, exist_ok=True)
        return checkpoint.save(
            path, state.model.state_dict(),
            scaling=getattr(self, "_current_scaling", None),
            opt_state=state.optimizer.state_dict(),
            rng=state.generator.get_state(), step=state.step,
            conf=self.conf.conf, resume_meta=resume_meta,
        )
