"""The numbers that decide ``correct``: the program's outputs against the
reference's, each a gap that has a limit of its own in the cell file.

Training (the first steps that set-up drives through the window's own
call and feed):

- ``loss_gap``: the largest relative gap of a step's loss;
- ``first_grad_gap``: of the first gradient as the optimizer gets it
  (clamped), each leaf's gap of norms, over the reference's norm of that
  leaf or of the median leaf, whichever is larger; the median over the
  leaves (``first_grad_worst``: the worst leaf);
- ``change_gap``: the same of each leaf's change after the steps
  (``change_worst``: the worst leaf).  Leaves whose first gradient in the
  reference is under a thousandth of the median leaf's (nought to
  rounding) are left out: they move by round-off alone;
- ``head_grad_diff``: of the leaves after the backbone (the head, the
  nested LSTM), the worst norm of the difference between the program's
  first gradient and the reference's, over the larger of that leaf's
  reference norm and the median leaf's.  Gaps of norms miss what the
  float8 control does to those leaves, a change of direction more than of
  size.  ``head_free_diff``: the same over the elements the reference
  leaves under the clamp alone, of the leaves with ``FREE_MIN`` of them or
  more (0 where none has): the clamp saturates most of the first
  gradient of a Linear head over a window's S x 128 features, and the
  elements it saturates agree whatever the precision.  ``head_free_n``
  counts those elements.

The worst leaf of a bfloat16 run reads 0.06-0.23 on every seed, as the
reference rounded to bfloat16 where the run rounds does: the norms'
scale and shift in the first dense layers, whose gradients cancel in
the backward pass.  The median leaf is steady from seed to seed, so it
is the one compared; ``calibrate.py`` prints the worst beside it.

The test epoch (every window of the window's first epoch):

- ``pred_gap``: the widest gap by which the logit of the class the
  program predicted lies below the reference's best logit for that window;
- ``vote_gap``: the largest gap of a patient's vote from the share of
  the windows the program predicted ARDS for that patient, the vote's
  rule applied to the program's own answers (each of which ``pred_gap``
  holds to the reference): exact.  ``vote_ref_gap``, the gap from the
  vote of the reference's own predictions, is reported beside it: it
  averages a patient's ~1,300 windows, so the float8 control moves it
  less than three times as far as a sound run does;
- ``test_loss_gap``: the largest relative gap of a step's test loss;
- ``logit_gap``, where the program's answers hold its logits (a nested
  test epoch's record keeps them): the widest gap between a window's
  logit and the reference's.  A nested network's windows lean to one
  class by a wide margin, so no rounding flips a prediction and
  ``pred_gap`` reads 0 on sound runs and on the control alike;
- ``own_loss_gap``, where the answers hold the logits: the largest
  relative gap of a step's recorded test loss from the BCE, in float64,
  of the logits the program recorded for that step's windows against
  their targets.  Both sides read the same float32 logits, so a sound run
  reads the loss's rounding, while a loss taken over part of the windows
  moves the mean.  ``logit_gap`` holds those logits to the reference.

Every cell (what the window ran, against the epochs the reference works
out): ``windows_gap``, the real windows the program's steps held (the
sum of their masks) less the windows of the epochs run; ``steps_gap``,
the larger of the steps run less the epochs' steps and the losses
recorded less the steps run.  Both are exact.
"""
import math

import numpy as np

BACKBONE = "breath_block."  # the names of the backbone's leaves
# the elements under the clamp a leaf needs for ``head_free_diff``: a
# relative norm over fewer is noise
FREE_MIN = 100


def _leaf_gaps(prog, ref, leaves):
    scale = float(np.median([ref[k] for k in leaves]))
    return [abs(prog[k] - ref[k]) / max(ref[k], scale, 1e-30)
            for k in leaves]


def _rel_gaps(prog, ref):
    prog, ref = np.asarray(prog, np.float64), np.asarray(ref, np.float64)
    if prog.shape != ref.shape or not np.isfinite(prog).all():
        return math.inf
    return float(np.max(np.abs(prog - ref) / np.maximum(np.abs(ref),
                                                        1e-30)))


def _diff_gaps(prog, ref, leaves, scale):
    """Each leaf's norm of the difference of two tensors, over the
    reference's norm of that leaf or ``scale``, whichever is larger."""
    return [float((prog[k] - ref[k]).norm()) / max(float(ref[k].norm()),
                                                   scale, 1e-30)
            for k in leaves]


def _free_diffs(prog, ref, leaves, clip):
    """{leaf: the norm of the difference of two first gradients over the
    elements the reference leaves under the clamp, over the reference's
    norm there} of the leaves with ``FREE_MIN`` such elements or more."""
    out = {}
    for k in leaves:
        under = ref[k].abs() < clip * (1.0 - 1e-6)
        if int(under.sum()) >= FREE_MIN:
            out[k] = float((prog[k][under] - ref[k][under]).norm()) / max(
                float(ref[k][under].norm()), 1e-30)
    return out


def train_numbers(prog, ref):
    """{name: value} of a program's first steps ``prog`` ({"losses",
    "first_grad", "first_grad_t", "change"}) against the reference's
    ``train_steps``."""
    leaves = sorted(ref["first_grad"])
    floor = 1e-3 * float(np.median([ref["grad_norm"][k] for k in leaves]))
    moved = [k for k in leaves if ref["grad_norm"][k] >= floor]
    head = [k for k in leaves if not k.startswith(BACKBONE)]
    out = {"loss_gap": _rel_gaps(prog["losses"], ref["losses"])}
    for name, key, names in (("first_grad", "first_grad", leaves),
                             ("change", "change", moved)):
        if sorted(prog[key]) != leaves or not all(
                math.isfinite(v) for v in prog[key].values()):
            gaps = [math.inf]
        else:
            gaps = _leaf_gaps(prog[key], ref[key], names)
        out[name + "_gap"] = float(np.median(gaps))
        out[name + "_worst"] = float(max(gaps))
    scale = float(np.median([ref["first_grad"][k] for k in leaves]))
    if sorted(prog["first_grad_t"]) != leaves or not all(
            math.isfinite(v) for v in prog["first_grad"].values()):
        out["head_grad_diff"] = out["head_free_diff"] = math.inf
    else:
        out["head_grad_diff"] = float(max(_diff_gaps(
            prog["first_grad_t"], ref["first_grad_t"], head, scale),
            default=0.0))
        free = _free_diffs(prog["first_grad_t"], ref["first_grad_t"],
                           head, ref["clip"])
        out["head_free_diff"] = float(max(free.values(), default=0.0))
        out["head_free_n"] = sum(
            int((ref["first_grad_t"][k].abs() < ref["clip"]).sum())
            for k in head)
    return out


def eval_numbers(prog, ref_logits, patient_of_row, ref_losses):
    """{name: value} of a test epoch's answers ``prog`` ({"preds": {row:
    class}, "votes": {patient: share}, "losses": [...]}, and optionally
    "logits": {row: (2,) array}) against the
    reference's logits ``ref_logits`` ({row: (2,) array}) and its step
    losses."""
    gaps, ref_class = [], {}
    for row, logits in ref_logits.items():
        ref_class[row] = int(np.argmax(logits))
        pred = prog["preds"].get(row)
        gaps.append(math.inf if pred is None
                    else float(np.max(logits) - logits[pred]))
    own = votes({r: prog["preds"].get(r, -1) for r in ref_class},
                patient_of_row)
    theirs = votes(ref_class, patient_of_row)
    out = {"pred_gap": max(gaps),
           "vote_gap": max(abs(prog["votes"].get(pt, math.inf) - v)
                           for pt, v in own.items()),
           "vote_ref_gap": max(abs(prog["votes"].get(pt, math.inf) - v)
                               for pt, v in theirs.items()),
           "test_loss_gap": _rel_gaps(prog["losses"], ref_losses)}
    if "logits" in prog:
        out["logit_gap"] = max(
            float(np.max(np.abs(prog["logits"][row] - logits)))
            if row in prog["logits"] else math.inf
            for row, logits in ref_logits.items())
    return out


def own_loss_gap(prog, steps, class_of_row):
    """The largest relative gap of a step's loss in ``prog["losses"]``
    from the BCE of the logits ``prog["logits"]`` of its rows ``steps[k]``
    against their one-hot targets: each row's mean over the two classes,
    then the mean over the rows."""
    if len(prog["losses"]) != len(steps):
        return math.inf
    gaps = []
    for loss, rows in zip(prog["losses"], steps):
        if any(r not in prog["logits"] for r in rows):
            return math.inf
        x = np.asarray([prog["logits"][r] for r in rows], np.float64)
        t = np.eye(2)[np.asarray(class_of_row)[rows]]
        bce = np.maximum(x, 0) - x * t + np.log1p(np.exp(-np.abs(x)))
        own = float(bce.mean())
        gap = abs(float(loss) - own) / max(abs(own), 1e-30)
        if not math.isfinite(gap):
            return math.inf
        gaps.append(gap)
    return max(gaps, default=0.0)


def count_numbers(counters, expected):
    """{windows_gap, steps_gap} of a window's counters against the
    ``expected`` (windows, steps) of the epochs it ran."""
    windows, steps = expected
    return {"windows_gap": abs(counters["windows"] - windows),
            "steps_gap": max(abs(counters["steps"] - steps),
                             abs(counters["recorded_losses"]
                                 - counters["steps"]))}


def votes(preds, patient_of_row):
    """{patient: the share of its windows predicted ARDS} of {row:
    class}: a patient's vote."""
    by_patient = {}
    for row, cls in preds.items():
        by_patient.setdefault(patient_of_row[row], []).append(cls)
    return {pt: int(np.sum(np.asarray(c) == 1)) / len(c)
            for pt, c in by_patient.items()}
