"""One float64 train step of the port's sharded path, for
``test_torch_distributed.py``: config 1's cnn_linear step and config 5's
ProtoPNet joint step (S = 4, a batch of 6 with one pad row, dropout on,
lr 0 so the step leaves the params and the optimizer sums and keeps the
gradients), and config 1's step at ``--bn-scope sequence`` over a batch
of 2 (one sample a rank, whose statistics stay its own), over every row
in one process or over this rank's rows of 2 ranks of
``torch.distributed`` (gloo).  It imports no JAX: the ranks run it as
``python torch_sharded_steps.py RANK PORT NETWORK OUT``.
"""
import sys

import numpy as np
import torch

# network: (benchmark config, its extra flags, rows, pad rows)
NETWORKS = {"config1": ("config1", (), 6, 1),
            "config5": ("config5", (), 6, 1),
            "config1_sequence": ("config1", ("--bn-scope", "sequence"), 2,
                                 0)}


def step_gradients(network):
    """{param: float64 gradient} of one step of ``network`` (a key of
    NETWORKS) over this process's rows, and the step's loss (its terms
    for ProtoPNet), summed over the ranks."""
    import chip_smoke
    from deepards_tpu_torch.parallel import mesh
    from deepards_tpu_torch.train.loop import make_trainer
    from deepards_tpu_torch.train.protopnet_trainer import make_ppnet_steps
    from deepards_tpu_torch.train.steps import TrainState, make_train_step

    torch.set_num_threads(1)
    config, flags, rows, pad = NETWORKS[network]
    conf = chip_smoke.config_conf(config, "--device", "cpu", "-nb", "4",
                                  "--dp-devices", "2", *flags)
    trainer = make_trainer(conf, verbose=False)
    trainer.n_sub_batches = 4
    state = trainer.new_state(0)
    model = state.model.to(torch.float64)
    rng = np.random.default_rng(0)
    data = torch.as_tensor(rng.normal(size=(rows, 4, 1, 224)))
    target = torch.as_tensor(np.eye(2)[rng.integers(0, 2, rows)])
    mask = torch.ones(rows, dtype=torch.float64)
    mask[rows - pad:] = 0.0
    if config == "config5":
        ident = torch.as_tensor(model.class_identity_windows(),
                                dtype=torch.float64)
        steps, _ = make_ppnet_steps(model, None, ident, model.max_dist)
        step = steps["joint"]
        optimizer = state.optimizer.stages["joint"]
    else:
        step, _ = make_train_step(trainer.loss_fn)
        optimizer = state.optimizer
    for group in optimizer.optimizer.param_groups:
        group["lr"] = 0.0
    mine = trainer.axis.local(rows)
    with mesh.sharded_rows(trainer.axis):
        loss = step(TrainState(model, optimizer, state.generator),
                    data[mine], target[mine], mask[mine])
    grads = {k: p.grad.numpy().copy() for k, p in model.named_parameters()
             if p.grad is not None}
    return grads, loss.numpy()


def main(rank, port, network, out):
    from deepards_tpu_torch.parallel import mesh

    mesh.initialize_distributed("127.0.0.1:{}".format(port), 2, rank)
    grads, loss = step_gradients(network)
    if rank == 0:
        np.savez(out, loss=loss, **{k.replace(".", "/"): v
                                    for k, v in grads.items()})


if __name__ == "__main__":
    main(int(sys.argv[1]), int(sys.argv[2]), sys.argv[3], sys.argv[4])
