"""The port's host epochs on the CPU, on the shared synthetic cohort
(cnn_linear/densenet18, S = 4, batch 8, fold 1 of 2: 108 windows):

- ``fused_steps`` 4 gives the losses and records of ``fused_steps`` 1,
  exactly, with and without augmentation (the warps draw from the host
  generator in the same order either way);
- a step-checkpoint resume gives the losses, records and final params of
  the run that saved it, exactly, with dropout and augmentation on;
- ``defer_fetch: false`` records what the deferred recording does.
"""
import pytest
import torch

from deepards_tpu_torch.config.config import Configuration
from deepards_tpu_torch.train import checkpoint
from deepards_tpu_torch.train import loop as tloop

torch.set_num_threads(1)

S = 4


def _run(cohort, tmp_path, **over):
    conf = dict(data_path=cohort["data_path"],
                cohort_file=cohort["cohort_file"], experiment_num=1,
                network="cnn_linear", base_network="densenet18",
                dataset_type="unpadded_centered_sequences", n_sub_batches=S,
                kfolds=2, only_fold=1, epochs=2, batch_size=8,
                learning_rate=0.001, clip_grad=True, clip_val=0.01,
                oversample_minority=True, compute_dtype="float32",
                device_cache=False, results_dir=str(tmp_path / "results"),
                saved_models_dir=str(tmp_path / "models"), seed=7)
    conf.update(over)
    trainer = tloop.Trainer(Configuration(overrides=conf), device="cpu",
                            verbose=False)
    trainer.train_and_test()
    return trainer


def _meters(trainer):
    return {k: v.values for k, v in trainer.results.reporting.meters.items()
            if k.startswith(("loss_epoch_", "test_loss_fold_"))}


@pytest.mark.parametrize("transforms", [None, ["ie_ww"]])
def test_fused_steps_equal_single_steps(synthetic_cohort, tmp_path,
                                        transforms):
    runs = [_run(synthetic_cohort, tmp_path / str(f), fused_steps=f,
                 transforms=transforms, transform_probability=0.5)
            for f in (1, 4)]
    single, fused = (_meters(t) for t in runs)
    assert single.keys() == fused.keys() and single
    assert single == fused
    assert runs[0].results.results == runs[1].results.results
    # 108 windows a fold: 14 steps an epoch, 3 chunks of 4 and 2 single
    assert len(single["loss_epoch_1_fold_1"]) == 14


def test_step_checkpoint_resume_equals_the_run(synthetic_cohort, tmp_path):
    """Dropout and augmentation on: the resumed run restores the params,
    momentum, dropout generator, the epoch's order and the host
    generator, so its losses after the checkpoint are the run's."""
    over = dict(transforms=["ie_ww"], transform_probability=0.5,
                fused_steps=4, checkpoint_every_n_steps=2,
                save_model="m.pt", compute_dtype="bfloat16")
    full = _run(synthetic_cohort, tmp_path / "full", **over)
    path = str(tmp_path / "full" / "models" / "m-epoch1-fold1-step8")
    meta = checkpoint.load_resume_meta(path)
    assert (meta["fold"], meta["epoch"], meta["next_batch"]) == (1, 1, 8)
    assert len(meta["perm"]) == 108
    resumed = _run(synthetic_cohort, tmp_path / "resumed",
                   load_checkpoint=path, **over)
    got, want = _meters(resumed), _meters(full)
    assert got["loss_epoch_1_fold_1"] == want["loss_epoch_1_fold_1"][8:]
    assert got["loss_epoch_2_fold_1"] == want["loss_epoch_2_fold_1"]
    assert got["test_loss_fold_1"] == want["test_loss_fold_1"]
    assert resumed.final_state.step == full.final_state.step
    for k, v in resumed.final_state.model.state_dict().items():
        assert torch.equal(v, full.final_state.model.state_dict()[k]), k


def test_defer_fetch_changes_no_record(synthetic_cohort, tmp_path):
    runs = [_run(synthetic_cohort, tmp_path / str(d), defer_fetch=d,
                 device_cache=None) for d in (True, False)]
    deferred, inline = (_meters(t) for t in runs)
    assert deferred == inline and deferred
    assert runs[0].results.results == runs[1].results.results
