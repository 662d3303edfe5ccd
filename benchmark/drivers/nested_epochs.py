"""The nested trainer's whole-patient epochs (``NestedTrainer``).

Set-up builds the fold as ``NestedTrainer.run_fold`` does (the fold's
state, its ``BucketRunners`` over the fold's normalization, the runner
of every bucket the fold's train patients fill, the cohort's windows in
the trainer's device cache), with the harness's weights and dropout
seed, the runners wrapped in the benchmark's probe.  An epoch is
``run_fold``'s: the train patients in ``host_rng.permutation`` order
through ``patient_steps``, their losses recorded through the trainer's
deferred queue.  The check follows the window's first epoch, whose order
the reference works out again: the train patients sorted by name, in
the trainer's first permutation of them, each with its own windows in
row order and then its oversampled ones.
"""
import numpy as np

from deepards_tpu_torch.data.pipeline import BatchPipeline
from deepards_tpu_torch.train.nested_trainer import (
    NestedTrainer,
    patient_groups,
)

from benchmark import trace
from benchmark.drivers import fold_epochs
from benchmark.reference import folds


class Driver(fold_epochs.Driver):
    trainer_class = NestedTrainer

    def __init__(self, run):
        super().__init__(run)
        if self.kind != "train":
            raise ValueError("the nested driver drives train epochs")

    def setup(self):
        self.build()
        trainer = self.trainer
        runners = trainer.nested_runners(
            self.state, BatchPipeline(self.train_ds, self.run.device),
            self.train_ds.cache.data.shape[1:])
        self.groups = patient_groups(self.train_ds)
        # a bucket's runner warms up and captures at its first use
        for size in sorted({folds.bucket(len(g[1])) for g in self.groups}):
            runners[size]
        self.runners = trace.BucketProbe(runners, self.run.clock)
        trainer._get_device_cache(self.train_ds)
        self.run.mark("runners")

    def epoch(self, number):
        trainer = self.trainer
        order = trainer.host_rng.permutation(len(self.groups))
        groups = [self.groups[i] for i in order]
        losses, _ = trainer.patient_steps(self.runners, self.train_ds,
                                          groups, train=True)
        trainer._defer(trainer._record_nested_losses, losses, self.fold)

    def patients(self):
        """[(patient, its rows)] of the fold's train patients sorted by
        name, as the reference works them out."""
        run = self.run
        train_pts, _ = folds.split(run.patient_of_row, run.class_of_row,
                                   run.conf.kfolds, self.fold)
        rows = self.epoch_rows()
        owner = np.asarray(run.patient_of_row)[rows]
        return [(pt, rows[owner == pt].tolist()) for pt in sorted(train_pts)]

    def expected(self, epochs):
        patients = self.patients()
        return (epochs * sum(len(r) for _, r in patients),
                epochs * len(patients))

    def check_steps(self):
        """Each of the window's first patients' rows, and their masks."""
        patients = self.patients()
        order = np.random.default_rng(self.run.conf.seed).permutation(
            len(patients))
        steps = [patients[k][1]
                 for k in order[:self.run.cell["check"]["steps"]]]
        return steps, [np.ones(len(s), np.float32) for s in steps]

    def free(self):
        super().free()
        self.runners = self.groups = None

    def reference(self, quant=None, leave_out_half=False):
        steps, masks = self.check_steps()
        drawn = [folds.bucket(len(s)) * self.run.n_sub_batches
                 for s in steps]
        return fold_epochs.train_reference(
            self.run, "cnn_to_nested_lstm", steps, drawn, quant,
            leave_out_half, masks)
