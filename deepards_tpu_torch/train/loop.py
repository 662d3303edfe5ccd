"""Fold/epoch training loop.

Counterpart of the standard ``Trainer`` of ``deepards_tpu/train/loop.py``.
Per fold it builds a fresh, seeded model and optimizer on the device,
trains it over fixed-size batches whose pad rows carry mask 0, evaluates
the fold's test patients, and feeds the per-window predictions to the
patient votes and AUC of ``deepards_tpu_torch.eval.metrics``.

The default epoch is the device-cache epoch: the dense window cache is
uploaded to the card once, each step gathers its batch there by index,
and the epoch's losses come back in one copy.  The host epoch
(``EpochLoader`` + ``PrefetchLoader``) runs when ``debug``,
``stop_on_loss`` or ``device_cache: false`` is set.  Steps run one at a
time: ``fused_steps`` and ``defer_fetch`` are accepted and change no
result.  Randomness: numpy ``default_rng(seed)`` streams for the
permutations and the oversampling (those of the JAX package, so both
draw the same batches in the same order), a ``torch.Generator`` per fold
for the init, and one per fold on the device for dropout.
"""
import os
import time

import numpy as np
import torch

from deepards_tpu_torch.data.dataset import ARDSRawDataset
from deepards_tpu_torch.data.pipeline import BatchPipeline
from deepards_tpu_torch.device import resolve_device
from deepards_tpu_torch.eval.metrics import DeepARDSResults
from deepards_tpu_torch.models.registry import (
    get_base_network,
    get_network_spec,
)
from deepards_tpu_torch.train import checkpoint
from deepards_tpu_torch.train import losses as loss_lib
from deepards_tpu_torch.train.loader import EpochLoader, PrefetchLoader
from deepards_tpu_torch.train.steps import (
    TrainState,
    make_optimizer,
    make_train_step,
)

# networks of the JAX package whose trainers the port does not have yet
_OTHER_TRAINERS = {
    "protopnet": "protopnet", "protopnet_2d": "protopnet",
    "siamese_cnn_linear": "siamese", "siamese_cnn_lstm": "siamese",
    "siamese_cnn_transformer": "siamese",
    "retinanet_2d": "detector", "retinanet_2x1d": "detector",
    "faster_rcnn_2d": "detector",
    "cnn_to_nested_rnn": "nested", "cnn_to_nested_lstm": "nested",
    "cnn_to_nested_transformer": "nested",
}

# options of the JAX trainer not ported yet: setting one raises
_UNPORTED_OPTIONS = (
    "transforms", "butter_low", "butter_high", "fft_filtering_low",
    "fft_filtering_high", "post_hoc_downsampling", "with_fft", "only_fft",
    "checkpoint_every_n_steps", "load_base_network", "freeze_base_network",
    "plot_untiled_disease_evol", "plot_tiled_disease_evol",
    "plot_dtw_with_disease", "perform_dtw_preprocessing",
    "plot_pt_dtw_by_minute", "distributed_coordinator",
)

_DTYPES = {"bfloat16": torch.bfloat16, "float32": None, None: None}


def make_trainer(conf, **kwargs):
    """The trainer a configuration asks for: the standard ``Trainer``, or
    ``NotImplementedError`` for those the port does not have yet."""
    if conf.get("parallel_folds"):
        raise NotImplementedError(
            "parallel_folds is not ported to deepards_tpu_torch yet")
    other = _OTHER_TRAINERS.get(conf.network)
    if other:
        raise NotImplementedError(
            "the {} trainer ({}) is not ported to deepards_tpu_torch "
            "yet".format(other, conf.network))
    return Trainer(conf, **kwargs)


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


class Trainer:
    """Config-driven experiment runner (the train_and_test surface)."""

    _DEVICE_CACHE_MAX_BYTES = 2 << 30  # larger caches take the host epoch

    def __init__(self, conf, device=None, verbose=True):
        self.conf = conf
        self.verbose = verbose
        unported = [k for k in _UNPORTED_OPTIONS if conf.get(k)]
        if unported:
            raise NotImplementedError(
                "options not ported to deepards_tpu_torch yet: "
                + ", ".join(unported))
        if conf.get("dp_devices", -1) not in (-1, 1, None):
            raise NotImplementedError(
                "dp_devices={}: the port trains on one device".format(
                    conf.get("dp_devices")))
        self.spec = get_network_spec(conf.network)
        self.device = resolve_device(
            device if device is not None else conf.get("device"))
        self.n_kfolds = (
            1 if conf.get("bootstrap") else (conf.get("kfolds") or 1)
        )
        self.start_time = str(int(time.time()))
        self.results = DeepARDSResults(
            self.start_time,
            conf.get("experiment_name"),
            results_dir=conf.get("results_dir") or "results",
            conf=dict(conf.conf),
        )
        self.seed = conf.get("seed", 42) or 42
        self.host_rng = np.random.default_rng(self.seed)
        self.compute_dtype = _DTYPES[conf.get("compute_dtype", "bfloat16")]
        self.loss_fn = loss_lib.get_classification_loss(
            conf.get("loss_func", "bce"),
            valpha=conf.get("valpha", float("inf")) or float("inf"),
            conf_beta=conf.get("conf_beta", 1.0) or 1.0,
        )
        self._dev_caches = {}

    # -- datasets -------------------------------------------------------------

    def get_base_datasets(self):
        """(reference: train_ards_detector.py:189-315)"""
        conf = self.conf
        seed = self.seed
        kfold_num = None if not conf.get("kfolds") else 0
        common = dict(
            oversample_minority=bool(conf.get("oversample_minority")),
            train_patient_fraction=conf.get("train_pt_frac", 1.0),
            undersample_factor=conf.get("undersample_factor", -1),
            undersample_std_factor=conf.get("undersample_std_factor", 0.2),
            oversample_all_factor=conf.get("oversample_all_factor", 1.0),
            random_kfold=bool(conf.get("random_kfold")),
            bootstrap=bool(conf.get("bootstrap")),
            seed=seed,
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
            )
        test_dataset.scaling_factors = train_dataset.scaling_factors
        if self.spec.uses_metadata and train_dataset.cache.meta is not None:
            raise NotImplementedError(
                "dataset_type {} carries metadata, and the port's {} has no "
                "metadata input yet".format(conf.dataset_type,
                                            self.spec.name))
        return train_dataset, test_dataset

    # -- model ----------------------------------------------------------------

    def _fold_seed(self, fold_num, stream):
        """A 32-bit seed for one fold's ``stream`` (0 init, 1 dropout)."""
        return int(np.random.SeedSequence(
            [self.seed, fold_num, stream]).generate_state(1)[0])

    def build_model(self):
        conf = self.conf.conf
        return self.spec.build(conf, get_base_network(conf),
                               self.n_sub_batches)

    def init_model(self, model, fold_num):
        """The fold's seeded initialization, drawn on the CPU (so the card
        and the CPU start from the same params)."""
        model.reset_parameters(
            torch.Generator().manual_seed(self._fold_seed(fold_num, 0)))

    def new_state(self, fold_num):
        """A fresh model, optimizer and dropout generator for a fold."""
        conf = self.conf
        model = self.build_model()
        self.init_model(model, fold_num)
        model.to(self.device)
        optimizer = make_optimizer(
            model.parameters(),
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

    # -- main loop ------------------------------------------------------------

    def train_and_test(self):
        """Every fold; with ``load_checkpoint``, each fold starts from that
        state, and a checkpoint saved after an epoch (its ``.resume.json``
        names the fold and the next epoch) resumes there."""
        conf = self.conf
        self.resume_meta = None
        if conf.get("load_checkpoint"):
            self.resume_meta = checkpoint.load_resume_meta(
                conf.load_checkpoint)
            if self.resume_meta and self.resume_meta.get("next_batch"):
                raise NotImplementedError(
                    "mid-epoch resume is not ported to deepards_tpu_torch "
                    "yet: resume from an epoch checkpoint")
        train_dataset, test_dataset = self.get_base_datasets()
        for fold_num in range(self.n_kfolds):
            if conf.get("only_fold") is not None and fold_num != conf.only_fold:
                continue
            if self.resume_meta and fold_num < self.resume_meta["fold"]:
                continue  # fold completed before the checkpoint
            if conf.get("kfolds") or conf.get("bootstrap"):
                if self.verbose:
                    print("--- Run Fold {} ---".format(fold_num + 1))
                train_dataset.set_kfold_indexes_for_fold(fold_num)
                test_dataset.set_kfold_indexes_for_fold(fold_num)
            # the fold's scaling goes into the checkpoint sidecars, so
            # serving normalizes without the dataset
            self._current_scaling = train_dataset.scaling_for_current_fold()
            self.run_fold(fold_num, train_dataset, test_dataset)
        self.perform_post_modeling_actions()
        return self.results

    def run_fold(self, fold_num, train_dataset, test_dataset):
        conf = self.conf
        self.last_train_count = len(train_dataset.current_indices())
        self.last_test_count = len(test_dataset.current_indices())
        state = self.new_state(fold_num)
        if conf.get("load_checkpoint"):
            self.restore_state(state, conf.load_checkpoint)
        train_step, eval_step = make_train_step(
            self.loss_fn,
            transform=BatchPipeline(train_dataset, self.device),
            compute_dtype=self.compute_dtype,
            eval_dropout_active=not self.spec.eval_dropout_off,
        )
        epochs = conf.get("epochs", 10)
        resume = self.resume_meta
        if not (resume and resume["fold"] == fold_num):
            resume = None
        start_epoch = resume["epoch"] if resume else 1
        for epoch_num in range(start_epoch, epochs + 1):
            if not conf.get("no_train"):
                self.run_train_epoch(
                    state, train_step, train_dataset, fold_num, epoch_num)
            if conf.get("reshuffle_oversample_per_epoch"):
                train_dataset.set_oversampling_indices()
            if not conf.get("no_test_after_epochs") or epoch_num == epochs:
                self.run_test_epoch(
                    state, eval_step, test_dataset, fold_num, epoch_num)
            if conf.get("save_model_per_epoch") and conf.get("save_model"):
                self.save_checkpoint(state, fold_num, epoch_num)
        if conf.get("save_model"):
            self.save_checkpoint(state, fold_num, None)
        if resume:
            self.resume_meta = None  # later folds run from scratch
        self.final_state = state
        return state

    # -- device-cache epochs --------------------------------------------------

    def _device_cache_eligible(self, dataset):
        """The default epoch: eligible when nothing needs the host inside
        the epoch (no stop-on-loss breaker, no debug single batch) and the
        cache fits, unless ``device_cache`` says otherwise."""
        conf = self.conf
        flag = conf.get("device_cache")
        if flag is False:
            return False
        if conf.get("stop_on_loss") or conf.get("debug"):
            return False
        if flag is not True and (dataset.cache.data.nbytes
                                 > self._DEVICE_CACHE_MAX_BYTES):
            return False
        return True

    def _get_device_cache(self, dataset):
        """The cache's data and targets on the device, uploaded once per
        ``cache.token``: the k-fold train and test views share one."""
        key = dataset.cache.token
        if key not in self._dev_caches:
            self._dev_caches[key] = {
                "data": torch.from_numpy(dataset.cache.data).to(self.device),
                "target": torch.from_numpy(dataset.cache.target).to(
                    self.device),
            }
        return self._dev_caches[key]

    def _device_batches(self, dataset, ids, masks):
        """(data, target, mask) per step, gathered on the device."""
        dev = self._get_device_cache(dataset)
        ids = torch.from_numpy(ids).to(self.device)
        masks = torch.from_numpy(masks).to(self.device)
        for step_ids, mask in zip(ids, masks):
            yield (dev["data"].index_select(0, step_ids),
                   dev["target"].index_select(0, step_ids), mask)

    def _run_train_epoch_device_cache(self, state, train_step, dataset,
                                      fold_num, epoch_num):
        conf = self.conf
        idx = np.asarray(dataset.current_indices())
        perm = idx if conf.get("unshuffled") else self.host_rng.permutation(
            idx)
        ids, masks = _epoch_order(perm, conf.get("batch_size", 16))
        if self.verbose:
            print("train instances: {} (device-cache epoch)".format(
                len(ids)))
        losses = [train_step(state, data, target, mask)
                  for data, target, mask in self._device_batches(
                      dataset, ids, masks)]
        self._record_train_losses(
            torch.stack(losses).cpu().numpy(), fold_num, epoch_num)

    def _record_train_losses(self, losses, fold_num, epoch_num):
        for loss in losses:
            self.results.update_meter(
                "loss_epoch_{}".format(epoch_num), fold_num, float(loss))
            self.results.update_loss(fold_num, float(loss))

    # -- host epochs ----------------------------------------------------------

    def _to_device(self, batch, batch_size):
        """Pad a gathered batch to ``batch_size`` and copy it to the
        device: (data, target, mask)."""
        batch, mask = _pad_batch(batch, batch_size)
        return (torch.from_numpy(batch["data"]).to(self.device),
                torch.from_numpy(batch["target"]).to(self.device),
                torch.from_numpy(mask).to(self.device))

    def run_train_epoch(self, state, train_step, dataset, fold_num,
                        epoch_num):
        conf = self.conf
        if self._device_cache_eligible(dataset):
            return self._run_train_epoch_device_cache(
                state, train_step, dataset, fold_num, epoch_num)
        batch_size = conf.get("batch_size", 16)
        loader = EpochLoader(
            dataset,
            batch_size,
            shuffle=not conf.get("unshuffled"),
            rng=self.host_rng,
        )
        if self.verbose:
            print("train instances: {}".format(len(loader)))

        def prepare(batch):
            batch.pop("index")
            return self._to_device(batch, batch_size)

        def record(loss):
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

        # the loss of step N is read after step N+1 is queued, so the
        # device never waits on the host; the stop-on-loss breaker fires
        # one step late, as in the JAX package
        prev_loss = None
        for data, target, mask in PrefetchLoader(loader, map_fn=prepare):
            loss = train_step(state, data, target, mask)
            if prev_loss is not None and record(prev_loss):
                prev_loss = None
                break
            prev_loss = loss
            if conf.get("debug"):
                break
        if prev_loss is not None:
            record(prev_loss)

    def run_test_epoch(self, state, eval_step, dataset, fold_num, epoch_num):
        batch_size = self.conf.get("batch_size", 16)
        idx = np.asarray(dataset.current_indices())
        if self._device_cache_eligible(dataset):
            ids, masks = _epoch_order(idx, batch_size)
            batches = self._device_batches(dataset, ids, masks)
        else:
            loader = EpochLoader(dataset, batch_size, shuffle=False)
            batches = PrefetchLoader(loader, map_fn=lambda b: self._to_device(
                {"data": b["data"], "target": b["target"]}, batch_size))
        losses, outs = [], []
        for data, target, mask in batches:
            loss, out = eval_step(state, data, target, mask)
            losses.append(loss)
            outs.append(out)
        # both paths visit idx in order; the pad rows end the last batch
        self._record_eval(torch.stack(losses).cpu().numpy(),
                          torch.cat(outs)[:len(idx)].cpu().numpy(), idx,
                          dataset, fold_num, epoch_num)

    def _record_eval(self, losses, outs, idx, dataset, fold_num, epoch_num):
        """Test losses per step, then the per-window predictions
        (``outs`` (n, 2) logits of the windows ``idx``)."""
        for loss in losses:
            self.results.update_meter("test_loss", fold_num, float(loss))
            self.results.update_epoch_meter("test_loss", epoch_num,
                                            float(loss))
        self.record_classifier_results(outs.argmax(axis=-1), idx, dataset,
                                       fold_num, epoch_num)

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

    def perform_post_modeling_actions(self):
        self.results.aggregate_classification_results(verbose=self.verbose)
        self.results.save_all()

    # -- checkpointing --------------------------------------------------------

    def save_checkpoint(self, state, fold_num, epoch_num):
        """``<saved_models_dir>/<name>[-epochN][-foldK]`` with its
        scaling and configuration sidecars; after an epoch, also the
        resume point (this fold, the next epoch)."""
        base = self.conf.get("save_model") or "model"
        name = os.path.splitext(os.path.basename(base))[0]
        if epoch_num is not None:
            name += "-epoch{}".format(epoch_num)
        if self.n_kfolds > 1:
            name += "-fold{}".format(fold_num)
        out_dir = self.conf.get("saved_models_dir") or "saved_models"
        os.makedirs(out_dir, exist_ok=True)
        return checkpoint.save(
            os.path.join(out_dir, name), state.model.state_dict(),
            scaling=getattr(self, "_current_scaling", None),
            opt_state=state.optimizer.state_dict(),
            rng=state.generator.get_state(), step=state.step,
            conf=self.conf.conf,
            resume_meta=None if epoch_num is None else {
                "fold": fold_num, "epoch": epoch_num + 1, "next_batch": 0},
        )
