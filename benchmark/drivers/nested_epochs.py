"""The nested trainer's whole-patient epochs (``NestedTrainer``).

Set-up builds the fold as ``NestedTrainer.run_fold`` does (the fold's
state, its ``BucketRunners`` over the fold's normalization, the runner
of every bucket the epoch's patients fill, the cohort's windows in the
trainer's device cache), with the harness's weights and dropout seed,
the runners wrapped in the benchmark's probe.  An epoch is one of
``run_fold``'s: the train patients in ``host_rng.permutation`` order
through ``patient_steps``, their losses recorded through the trainer's
deferred queue; or the test patients sorted by name, forward only, their
losses and each real window's prediction recorded through
``_record_nested_eval``, whose first record's logits the driver keeps
for the check: against the reference's, and each patient's recorded
loss against the BCE of its own recorded logits.  The check follows the
window's first epoch, whose order the reference works out again: the
patients sorted by name, a train epoch in the trainer's first
permutation of them, each with its own windows in row order and then
its oversampled ones.
"""
import numpy as np

from deepards_tpu_torch.data.pipeline import BatchPipeline
from deepards_tpu_torch.train.nested_trainer import (
    NestedTrainer,
    patient_groups,
)

from benchmark import checks, trace
from benchmark.drivers import fold_epochs
from benchmark.reference import folds


class Driver(fold_epochs.Driver):
    trainer_class = NestedTrainer

    def setup(self):
        self.build()
        trainer = self.trainer
        runners = trainer.nested_runners(
            self.state, BatchPipeline(self.train_ds, self.run.device),
            self.train_ds.cache.data.shape[1:])
        self.groups = patient_groups(self.dataset())
        # a bucket's runner warms up and captures at its first use
        for size in sorted({folds.bucket(len(g[1])) for g in self.groups}):
            runners[size]
        self.runners = trace.BucketProbe(runners, self.run.clock)
        trainer._get_device_cache(self.dataset())
        self.run.mark("runners")

    def epoch(self, number):
        trainer = self.trainer
        if self.kind == "test":
            losses, outs = trainer.patient_steps(
                self.runners, self.test_ds, self.groups, train=False)
            trainer._defer(self.record_eval, losses, outs, number)
            return
        order = trainer.host_rng.permutation(len(self.groups))
        groups = [self.groups[i] for i in order]
        losses, _ = trainer.patient_steps(self.runners, self.train_ds,
                                          groups, train=True)
        trainer._defer(trainer._record_nested_losses, losses, self.fold)

    def record_eval(self, losses, outs, number):
        """``_record_nested_eval``, keeping the first epoch's record of
        the windows' logits."""
        trainer = self.trainer
        trainer._record_nested_eval(losses, outs, self.groups, self.test_ds,
                                    self.fold, number)
        if number == 1:
            self.snapshot["eval"] = trainer.last_eval

    def answers(self):
        """The test answers of ``fold_epochs`` and each window's logits as
        the first epoch recorded them."""
        out = super().answers()
        if self.kind == "test":
            first = self.snapshot.get("eval") or {"index": [], "logits": []}
            out["logits"] = dict(zip(np.asarray(first["index"]).tolist(),
                                     first["logits"]))
        return out

    def as_answers(self, ref):
        out = super().as_answers(ref)
        if self.kind == "test":
            out["logits"] = ref["logits"]
        return out

    def numbers(self, answers, ref):
        out = super().numbers(answers, ref)
        if self.kind == "test":
            out["own_loss_gap"] = checks.own_loss_gap(
                answers, self.test_steps()[0], self.run.class_of_row)
        return out

    def patients(self):
        """[(patient, its rows)] of the epoch's patients sorted by name,
        as the reference works them out."""
        rows = self.epoch_rows()
        owner = np.asarray(self.run.patient_of_row)[rows]
        return [(pt, rows[owner == pt].tolist())
                for pt in sorted(set(owner.tolist()))]

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

    def test_steps(self, leave_out_half=False):
        """Each test patient's rows and mask, by name: every window real;
        ``leave_out_half``: the second half of a patient's windows
        masked out of its loss."""
        steps = [rows for _, rows in self.patients()]
        masks = [np.ones(len(s), np.float32) for s in steps]
        if leave_out_half:
            for m in masks:
                m[len(m) - len(m) // 2:] = 0.0
        return steps, masks

    def first_step_rows(self):
        return self.test_steps()[0][0]

    def free(self):
        super().free()
        self.runners = self.groups = None

    def drawn_rows(self, steps):
        """A step's dropout draw: its patient's bucket of windows."""
        return [folds.bucket(len(s)) * self.run.n_sub_batches
                for s in steps]

    def reference(self, quant=None, leave_out_half=False):
        if self.kind == "train":
            steps, masks = self.check_steps()
            return fold_epochs.train_reference(
                self.run, self.network, steps, self.drawn_rows(steps), quant,
                leave_out_half, masks)
        steps, masks = self.test_steps(leave_out_half)
        # the program records every real window, whatever its mask
        return fold_epochs.test_reference(
            self.run, self.network, steps, masks, self.drawn_rows(steps),
            [np.ones(len(s), bool) for s in steps], quant)
