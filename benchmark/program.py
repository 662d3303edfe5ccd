"""What the harness hands to the program under test, and what it reads
back: the run's configuration, the cohort as the program's datasets, the
initial weights in its model.  The program is ``deepards_tpu_torch``."""
import os
import tempfile

import numpy as np
import torch

from deepards_tpu_torch.config.config import Configuration
from deepards_tpu_torch.data.dataset import ARDSRawDataset
from deepards_tpu_torch.data.windowing import WindowCache

from benchmark import cohort


def configuration(config, seed):
    """The program's ``Configuration`` of ``config``'s flags and seed."""
    return Configuration(overrides=dict(config["flags"], seed=int(seed)))


def datasets(conf, traffic, data):
    """(train, test) ``ARDSRawDataset`` views of fold ``traffic['fold']``
    over the cohort's windows ``data`` (N, S, C, L), as the program's ETL
    leaves them: scaling of every fold, the fold's splits, the train
    split oversampled as the configuration asks.  The cohort file the
    dataset reads goes to a temporary file, removed at once."""
    ids, ys, _ = cohort.rows(traffic)
    names = cohort.patient_ids(traffic)
    cache = WindowCache(
        data=data,
        target=np.eye(2, dtype=np.float32)[ys],
        hours=cohort.hours(traffic, data.shape[1]),
        patient_idx=np.repeat(np.arange(len(names)),
                              cohort.window_counts(traffic)).astype(np.int32),
        patients=names)
    fd, path = tempfile.mkstemp(suffix=".csv")
    try:
        with os.fdopen(fd, "w") as f:
            f.write("Patient Unique Identifier,Pathophysiology\n")
            f.writelines("{},{}\n".format(n, "ARDS" if y else "OTHER")
                         for n, y in zip(names, cohort.classes(traffic)))
        train = ARDSRawDataset(
            os.path.dirname(path), 1, path, data.shape[1],
            conf.dataset_type, cache=cache, kfold_num=traffic["fold"],
            total_kfolds=conf.kfolds,
            oversample_minority=bool(conf.get("oversample_minority")),
            seed=conf.seed)
    finally:
        os.remove(path)
    test = ARDSRawDataset.make_test_dataset_if_kfold(train)
    return train, test


def load_weights(model, weights):
    """Copy ``weights`` (name -> tensor) into ``model``'s parameters in
    place; the two must name the same leaves with the same shapes."""
    params = dict(model.named_parameters())
    if set(params) != set(weights):
        raise ValueError("the model's leaves and the weights differ: {}"
                         .format(sorted(set(params) ^ set(weights))))
    with torch.no_grad():
        for name, p in params.items():
            p.copy_(weights[name])


def first_momentum(state):
    """{name: SGD momentum buffer} of the state's optimizer."""
    by_id = {id(p): n for n, p in state.model.named_parameters()}
    return {by_id[id(p)]: s["momentum_buffer"].detach().clone()
            for p, s in state.optimizer.optimizer.state.items()
            if "momentum_buffer" in s}


def params(state):
    return {n: p.detach().clone() for n, p in state.model.named_parameters()}
