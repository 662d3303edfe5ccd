"""How far three float32 Adam steps of benchmark config 3's network
(cnn_regressor over densenet18, S = 1, lr 1e-3) part under a change of
summation order alone: the CPU against itself with the batch's rows
permuted (the pad row kept last).  For batches of 8 and 64, the port's
init and numpy-drawn params (as the port's tests give both packages), and
z-scored or shifted targets, it prints how many param elements part by
more than 1e-5 after each step.

    python -m deepards_tpu_torch.train.adam_spread

runs on the CPU in about a minute.
"""
import itertools
import math

import numpy as np
import torch

from deepards_tpu_torch.data.pipeline import transform_batch
from deepards_tpu_torch.models.registry import (
    get_base_network,
    get_network_spec,
    n_bm_features,
)
from deepards_tpu_torch.train import losses
from deepards_tpu_torch.train.steps import (
    TrainState,
    make_optimizer,
    make_train_step,
)

CONF = {"network": "cnn_regressor", "base_network": "densenet18",
        "dataset_type": "padded_breath_by_breath_with_full_bm_target"}
L = 224
ATOL = 1e-5
# targets as (scale, shift) of N(0, 1): z-scored, or the tests' 2N + 1
TARGETS = {"N(0,1)": (1.0, 0.0), "2N(0,1)+1": (2.0, 1.0)}


def build():
    return get_network_spec(CONF["network"]).build(
        CONF, get_base_network(CONF), 1)


def drawn_params(model, seed=5):
    """Kernels N(0, 1/fan_in), norm scales 1 + N(0, 0.01), biases
    N(0, 0.01), drawn by numpy."""
    rng = np.random.default_rng(seed)
    out = {}
    for n, v in model.state_dict().items():
        if v.ndim >= 2:
            value = rng.normal(size=v.shape) / math.sqrt(np.prod(v.shape[1:]))
        elif "norm" in n and n.endswith("weight"):
            value = 1 + 0.1 * rng.normal(size=v.shape)
        else:
            value = 0.1 * rng.normal(size=v.shape)
        out[n] = torch.from_numpy(value.astype(np.float32))
    return out


def three_steps(init, data, target, mask, rows):
    """Params after each of 3 Adam steps over the batches' ``rows``."""
    model = build()
    model.load_state_dict(init)
    state = TrainState(model, make_optimizer(model.parameters(), "adam",
                                             learning_rate=1e-3),
                       torch.Generator())
    mu, std = torch.tensor([3.0]), torch.tensor([20.0])
    step, _ = make_train_step(
        losses.mse, transform=lambda d: transform_batch(d, mu, std),
        dropout_active=False, target_mode="regression")
    out = []
    for k in range(3):
        step(state, *(torch.from_numpy(x[rows])
                      for x in (data[k], target[k], mask)))
        out.append({n: v.detach().clone()
                    for n, v in model.state_dict().items()})
    return out


def spread(init, batch, targets, seed=4):
    """Elements over ``ATOL`` after each step, rows in order against
    permuted, on Gaussian windows as the tests draw them."""
    rng = np.random.default_rng(seed)
    data = (rng.normal(size=(3, batch, 1, 1, L)) * 20 + 3).astype(np.float32)
    scale, shift = TARGETS[targets]
    target = (rng.normal(size=(3, batch, n_bm_features(CONF))) * scale
              + shift).astype(np.float32)
    mask = np.ones(batch, np.float32)
    mask[-1] = 0.0
    permuted = np.append(rng.permutation(batch - 1), batch - 1)
    a, b = (three_steps(init, data, target, mask, rows)
            for rows in (np.arange(batch), permuted))
    return [sum(int(((x[n] - y[n]).abs() > ATOL).sum()) for n in x)
            for x, y in zip(a, b)]


def main():
    model = build().reset_parameters(torch.Generator().manual_seed(0))
    inits = {"port init": {n: v.clone()
                           for n, v in model.state_dict().items()},
             "numpy draws": drawn_params(model)}
    total = sum(v.numel() for v in inits["port init"].values())
    print("float32 Adam, CPU rows in order vs permuted: param elements "
          "(of {}) over {} after steps 1, 2, 3".format(total, ATOL))
    for batch, params, targets in itertools.product(
            (8, 64), inits, TARGETS):
        print("batch {:2d}, {:11s}, targets {:9s}: {}".format(
            batch, params, targets, spread(inits[params], batch, targets)),
            flush=True)


if __name__ == "__main__":
    main()
