"""The standard trainer's device-cache epochs (``Trainer``: a batch of
samples a step).

Set-up builds the fold as ``Trainer.run_fold`` does (the fold's state,
its train and eval steps, its ``StepRunner`` with the graphs captured,
the cohort's windows in the trainer's device cache), with the harness's
weights and dropout seed, the runner wrapped in the benchmark's probe.
An epoch is ``Trainer.run_train_epoch`` or ``Trainer.run_test_epoch``,
whose records wait in the trainer's deferred queue until the window's
end.  A train cell's check follows the window's first epoch: the probe
takes the optimizer's first momentum after its first step and the
parameters after its ``check.steps``-th, and the reference works out
that epoch's order again (the fold's rows, oversampled, in the
permutation the trainer's ``host_rng`` draws first).
"""
import numpy as np
import torch

from deepards_tpu_torch.train.loop import Trainer
from deepards_tpu_torch.train.steps import make_train_step

from benchmark import checks, program, trace
from benchmark.reference import folds, runs


class Driver:
    trainer_class = Trainer

    def __init__(self, run):
        self.run = run
        self.kind = run.traffic["epoch"]
        if self.kind not in ("train", "test"):
            raise ValueError("unknown epoch kind: {}".format(self.kind))
        self.fold = run.traffic["fold"]
        self.network = run.config["flags"]["network"]
        self.snapshot = {}

    # -- set-up ---------------------------------------------------------

    def build(self):
        """The trainer, the fold's datasets and its state with the
        harness's weights and dropout seed."""
        run = self.run
        self.trainer = self.trainer_class(run.conf, device=run.device,
                                          verbose=False)
        self.train_ds, self.test_ds = program.datasets(
            run.conf, run.traffic, run.data)
        run.mark("datasets")
        # what get_base_datasets sets from the datasets it builds
        self.trainer.n_sub_batches = self.train_ds.n_sub_batches
        self.trainer.in_channels = self.train_ds.cache.data.shape[2]
        self.state = self.trainer.fold_state(self.fold)
        program.load_weights(self.state.model, run.weights)
        self.state.generator.manual_seed(run.seeds["dropout"])
        run.mark("state")

    def dataset(self):
        """The split the window's epochs visit."""
        return self.train_ds if self.kind == "train" else self.test_ds

    def setup(self):
        self.build()
        trainer = self.trainer
        steps = make_train_step(trainer.loss_fn,
                                **trainer.step_options(self.train_ds))
        self.runner = trace.RunnerProbe(
            trainer.make_runner(self.state, self.train_ds, *steps),
            self.run.clock)
        self.batch = trainer.batch_rows()[0]
        # the epoch's first call would upload the cache
        trainer._get_device_cache(self.dataset())
        self.run.mark("runner")

    def hooks(self, clock, calls0):
        """A train cell's snapshots of the state inside the window's first
        epoch: the first momentum after its first step, the parameters
        after the check's last."""
        if self.kind != "train":
            return
        clock.after(calls0 + 1, self.take_momentum)
        clock.after(calls0 + self.run.cell["check"]["steps"],
                    self.take_params)

    def take_momentum(self):
        self.snapshot["momentum"] = program.first_momentum(self.state)

    def take_params(self):
        self.snapshot["params"] = program.params(self.state)

    # -- the window -----------------------------------------------------

    def fetch_scope(self):
        return self.trainer.deferred_fetch()

    def epoch(self, number):
        if self.kind == "train":
            self.trainer.run_train_epoch(self.runner, self.train_ds,
                                         self.fold, number)
        else:
            self.trainer.run_test_epoch(self.runner, self.test_ds,
                                        self.fold, number)

    def losses(self):
        meter = "loss" if self.kind == "train" else "test_loss"
        return self.trainer.results.get_meter(meter, self.fold).values

    # -- the check ------------------------------------------------------

    def expected(self, epochs):
        """(real windows, steps) of ``epochs`` epochs, as the reference
        works out an epoch."""
        rows = self.epoch_rows()
        return epochs * len(rows), epochs * -(-len(rows) // self.batch)

    def epoch_rows(self):
        """The rows an epoch visits, as the reference works them out: the
        fold's train patients' rows, oversampled, or its test patients'."""
        run = self.run
        train_pts, test_pts = folds.split(run.patient_of_row,
                                          run.class_of_row,
                                          run.conf.kfolds, self.fold)
        if self.kind == "test":
            return folds.rows_of(run.patient_of_row, test_pts)
        rows = folds.rows_of(run.patient_of_row, train_pts)
        if run.conf.get("oversample_minority"):
            rows = folds.oversampled(rows, run.class_of_row, run.conf.seed)
        return rows

    def check_steps(self):
        """(ids, masks) of the window's first train steps that the check
        compares: the first epoch's order, the trainer's first
        ``host_rng`` permutation of its rows in batches."""
        order = np.random.default_rng(self.run.conf.seed).permutation(
            self.epoch_rows())
        ids, masks = folds.batches(order, self.batch)
        n = self.run.cell["check"]["steps"]
        return ids[:n], masks[:n]

    def test_steps(self, leave_out_half=False):
        """(ids, masks) of the window's first test epoch as the reference
        works it out: the fold's test rows in order, in batches;
        ``leave_out_half``: the second half of each batch masked out."""
        ids, masks = folds.batches(self.epoch_rows(), self.batch)
        if leave_out_half:
            masks[:, self.batch - self.batch // 2:] = 0.0
        return ids, masks

    def first_step_rows(self):
        """The rows the first test step scores."""
        ids, masks = self.test_steps()
        return ids[0][masks[0] > 0].tolist()

    def answers(self):
        """What the check compares, read from the program once the
        window has closed."""
        if self.kind == "train":
            n = self.run.cell["check"]["steps"]
            return first_step_readings(self.run, self.losses()[:n],
                                       self.snapshot.get("momentum"),
                                       self.snapshot.get("params"))
        results = self.trainer.results
        epoch_steps = self.expected(1)[1]
        return {
            "preds": {r["index"]: r["pred"]
                      for r in results.all_pred_to_hour if r["epoch"] == 1},
            "votes": {r["patient"]: r["pred_frac"] for r in results.results
                      if r["epoch_num"] == 1},
            "losses": self.losses()[:epoch_steps]}

    def free(self):
        self.trainer = self.runner = self.state = None
        self.train_ds = self.test_ds = None
        self.snapshot = {}

    def reference(self, quant=None, leave_out_half=False):
        """The reference's run of what the check compares; ``quant`` and
        ``leave_out_half`` make it a control or a fault."""
        if self.kind == "train":
            ids, masks = self.check_steps()
            return train_reference(self.run, self.network, list(ids),
                                   self.batch * self.run.n_sub_batches,
                                   quant, leave_out_half, list(masks))
        ids, masks = self.test_steps(leave_out_half)
        return test_reference(self.run, self.network, list(ids), list(masks),
                              self.batch * self.run.n_sub_batches,
                              list(masks > 0), quant)

    def numbers(self, answers, ref):
        if self.kind == "train":
            return checks.train_numbers(answers, ref)
        return checks.eval_numbers(answers, ref["logits"],
                                   self.run.patient_of_row, ref["losses"])

    def as_answers(self, ref):
        """A reference run's outputs as the program's answers."""
        if self.kind == "train":
            return ref
        return test_answers(ref, self.run.patient_of_row)


def first_step_readings(run, losses, momentum, params_after):
    """The program's readings of the check's steps: the losses, each
    leaf's first gradient as the optimizer got it (the first momentum
    less the decay) and the norm of its change.  A snapshot the window
    never took reads as no leaves."""
    wd = run.conf.weight_decay
    w0 = run.weights
    grads = {k: (m - wd * w0[k]).float().cpu()
             for k, m in (momentum or {}).items()}
    return {
        "losses": [float(x) for x in losses],
        "first_grad": {k: float(g.norm()) for k, g in grads.items()},
        "first_grad_t": grads,
        "change": {k: float((p - w0[k]).norm())
                   for k, p in (params_after or {}).items()}}


def _upload(run, rows):
    """(rows' windows on the device, their targets, the map from a cohort
    row to its place in them)."""
    rows = np.unique(np.asarray(rows))
    where = np.full(len(run.class_of_row), -1, np.int64)
    where[rows] = np.arange(len(rows))
    data = torch.from_numpy(run.data[rows]).to(run.device)
    targets = torch.from_numpy(np.eye(2, dtype=np.float32)[
        run.class_of_row[rows]]).to(run.device)
    return data, targets, where


def fold_scaling(run, fold):
    train_pts, _ = folds.split(run.patient_of_row, run.class_of_row,
                               run.conf.kfolds, fold)
    return folds.scaling(run.data,
                         folds.rows_of(run.patient_of_row, train_pts),
                         run.device)


def train_reference(run, network, steps, drawn_rows, quant=None,
                    leave_out_half=False, masks=None):
    """The reference over the check's steps (each a list of cohort rows,
    with its 0/1 row mask in ``masks``, all ones where None)."""
    mu, std = fold_scaling(run, run.traffic["fold"])
    data, targets, where = _upload(run, [r for s in steps for r in s])
    conf = run.conf
    return runs.train_steps(
        network, run.weights, data, targets, [where[s] for s in steps],
        mu, std, run.seeds["dropout"], drawn_rows,
        {"lr": conf.learning_rate, "weight_decay": conf.weight_decay,
         "clip": conf.clip_val},
        quant=quant, leave_out_half=leave_out_half, masks=masks)


def test_reference(run, network, steps, masks, drawn_rows, keep,
                   quant=None):
    """The reference over the fold's first test epoch, whose step k
    scores the cohort rows ``steps[k]`` with the 0/1 row mask
    ``masks[k]``: {"logits": {row: (2,) logits of the rows ``keep[k]``
    marks}, "losses": each step's loss}."""
    mu, std = fold_scaling(run, run.traffic["fold"])
    data, targets, where = _upload(run, [r for s in steps for r in s])
    logits, losses = runs.test_logits(
        network, run.weights, data, targets, [where[s] for s in steps], masks,
        mu, std, run.seeds["dropout"], drawn_rows, quant)
    out = {}
    for rows, step_logits, step_keep in zip(steps, logits, keep):
        for r, v, k in zip(rows, step_logits.cpu().numpy(), step_keep):
            if k:
                out[int(r)] = v
    return {"logits": out, "losses": losses}


def test_answers(ref, patient_of_row):
    """A test reference's logits as answers: each row's predicted class,
    each patient's vote."""
    preds = {r: int(np.argmax(v)) for r, v in ref["logits"].items()}
    return {"preds": preds, "votes": checks.votes(preds, patient_of_row),
            "losses": ref["losses"]}
