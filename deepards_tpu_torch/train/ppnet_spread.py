"""How far a ProtoPNet run (benchmark config 5's trainer) parts from
itself when every initial param is nudged by 1e-7 of its value: the
conditioning that decides which schedule a run of the port can be held to
another framework's over.  Fold 0 of 2 on a seeded synthetic cohort (8
patients x 260 breaths, S = 4, batch 8, float32, densenet18 with dropout
off), twice per setting: as initialized, and nudged.  For each schedule and
learning rate it prints the largest per-step difference of each epoch's
train losses and of the test losses.

    python -m deepards_tpu_torch.train.ppnet_spread

runs on the CPU in about 3 minutes.
"""
import os
import tempfile

import numpy as np
import torch

from deepards_tpu_torch.cli.train import main as train_main
from deepards_tpu_torch.data.synthetic import generate_cohort
from deepards_tpu_torch.models import densenet1d, registry
from deepards_tpu_torch.train.protopnet_trainer import ProtoPNetTrainer

NUDGE = 1e-7
# (name, flags): through a joint epoch, and warm epochs with pushes and
# last-layer epochs only
SCHEDULES = (
    ("warm, joint, joint; pushes at 2 and 3",
     ["--epochs", "3", "--n-warm-epochs", "1", "-pse", "2",
      "--push-every-n", "1", "--n-push-iters", "1"]),
    ("warm, warm; a push after each",
     ["--epochs", "2", "--n-warm-epochs", "2", "-pse", "1",
      "--push-every-n", "1", "--n-push-iters", "1"]),
)
RATES = ("1e-4", "1e-5", "1e-6")


def run(cohort, workdir, schedule, lr, nudge):
    """The run's loss meters (train per epoch, test) with every initial
    param times 1 + ``nudge``."""
    def init(self, model, fold):
        model.reset_parameters(torch.Generator().manual_seed(fold))
        with torch.no_grad():
            for p in model.parameters():
                p.mul_(1 + nudge)

    ProtoPNetTrainer.init_model = init
    trainer = train_main([
        "--data-path", os.path.dirname(cohort), "--cohort-file", cohort,
        "--network", "protopnet", "-nb", "4", "--kfolds", "2",
        "--only-fold", "0", "--batch-size", "8", "-lr", lr,
        "--compute-dtype", "float32", "--seed", "7", "--device", "cpu",
        "--results-dir", os.path.join(workdir, "results")] + schedule)
    return {k: np.asarray(v.values)
            for k, v in trainer.results.reporting.meters.items()
            if k.startswith(("loss_epoch_", "test_loss_fold_"))}


def main():
    # densenet18 without dropout, so two runs differ only by the nudge
    registry.BASE_NETWORKS["densenet18"] = lambda conf, c: \
        densenet1d.densenet18(in_channels=c, drop_rate=0.0)
    with tempfile.TemporaryDirectory() as workdir:
        cohort = generate_cohort(os.path.join(workdir, "cohort"),
                                 n_patients=8, n_breaths_per_patient=260,
                                 seed=1234)
        for name, schedule in SCHEDULES:
            for lr in RATES:
                base, nudged = (run(cohort, workdir, schedule, lr, n)
                                for n in (0.0, NUDGE))
                parts = ", ".join(
                    "{} {:.3g} (step {})".format(
                        key.replace("_fold_0", ""),
                        np.abs(base[key] - nudged[key]).max(),
                        int(np.argmax(np.abs(base[key] - nudged[key]) > 1e-4))
                        if (np.abs(base[key] - nudged[key]) > 1e-4).any()
                        else "-")
                    for key in sorted(base))
                print("{} at lr {}: {}".format(name, lr, parts), flush=True)


if __name__ == "__main__":
    main()
