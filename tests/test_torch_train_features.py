"""Config 1's trainer options in the port, against the JAX package where
it has the same function, on seeded inputs.

- the metadata head (``padded_breath_by_breath_with_flow_time_features``)
  and a model over the FFT channels of ``--with-fft``: logits of
  cnn_linear/densenet18 with the JAX params transplanted, dropout off,
  atol 1e-4;
- ``--load-base-network``: the backbone spliced bit for bit, from a port
  checkpoint and from an ``.npz`` of the JAX package's flat params;
- ``--freeze-base-network``: the backbone bit for bit unchanged after
  steps, and the head's first update equal to the JAX package's to 1e-9
  (an update is at most lr x 1.9 x (clip + wd |w|), ~2e-5).  The JAX
  package does not freeze: ``optax.masked`` passes the raw gradient
  through as the update of a masked-out leaf, so its backbone moves by
  +grad, which is pinned here against ``jax.grad`` of the same loss
  (atol 1e-5, rtol 1e-3: the jitted step and ``jax.grad`` sum the first
  conv's cancelling gradient in other orders; the gradient reaches
  1e-3 and more, and SGD would move by 1e-3 of it, the other way);
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deepards_tpu.data import pipeline as jpipeline
from deepards_tpu.models import densenet1d as jdn
from deepards_tpu.models import heads as jheads
from deepards_tpu.models.layers import bn_row_mask as jbn_row_mask
from deepards_tpu.train import losses as jlosses
from deepards_tpu.train import steps as jsteps
from deepards_tpu_torch.config.config import Configuration
from deepards_tpu_torch.data.pipeline import transform_batch
from deepards_tpu_torch.models.registry import (
    get_base_network,
    get_network_spec,
)
from deepards_tpu_torch.train import checkpoint
from deepards_tpu_torch.train import loop as tloop
from deepards_tpu_torch.train.losses import bce_with_logits
from deepards_tpu_torch.train.steps import make_train_step
from deepards_tpu_torch.transplant import transplant

torch.set_num_threads(1)

B, S, L = 4, 4, 224
MU, STD = np.float32([3.0]), np.float32([20.0])


def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if hasattr(v, "items"):
            out.update(_flat(v, prefix + k + "/"))
        else:
            out[prefix + k] = np.asarray(v)
    return out


def _port_model(channels=1, meta=0):
    conf = {"base_network": "densenet18"}
    return get_network_spec("cnn_linear").build(
        conf, get_base_network(conf, channels), S, meta)


def _inputs(seed, channels=1):
    rng = np.random.default_rng(seed)
    data = (rng.normal(size=(B, S, channels, L)) * 20 + 3).astype(np.float32)
    meta = rng.normal(size=(B, S, 9)).astype(np.float32)
    target = np.eye(2, dtype=np.float32)[rng.integers(0, 2, size=B)]
    mask = np.float32([1, 1, 1, 0])
    return data, meta, target, mask


@pytest.mark.parametrize("channels,meta", [(1, 9), (3, 0), (2, 0)])
def test_head_logits_match_jax(channels, meta):
    """The metadata input (9 flow-time features a window) and the FFT
    channels (3: flow, real, imaginary; 2: flow, real)."""
    data, metadata, _, mask = _inputs(channels, channels)
    jmodel = jheads.CNNLinearNetwork(breath_block=jdn.densenet18(),
                                     metadata_features=meta)
    jmeta = jnp.asarray(metadata) if meta else None
    params = jmodel.init({"params": jax.random.PRNGKey(0)},
                         jnp.asarray(data), jmeta, True)["params"]
    with jbn_row_mask(jnp.repeat(jnp.asarray(mask), S)):
        want = jmodel.apply({"params": params}, jnp.asarray(data), jmeta,
                            True)
    model = _port_model(channels, meta)
    model.load_state_dict(transplant(_flat(params)))
    rows = torch.from_numpy(mask).repeat_interleave(S)
    from deepards_tpu_torch.models.layers import bn_row_mask

    with torch.no_grad(), bn_row_mask(rows):
        got = model(torch.from_numpy(data), True, None,
                    torch.from_numpy(metadata))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-4,
                               rtol=0)


def _trainer(tmp_path, **over):
    conf = dict(network="cnn_linear", base_network="densenet18",
                optimizer="sgd", learning_rate=0.001, weight_decay=0.0001,
                clip_grad=True, clip_val=0.01, compute_dtype="float32",
                dp_devices=1, results_dir=str(tmp_path / "results"), seed=7)
    conf.update(over)
    trainer = tloop.Trainer(Configuration(overrides=conf), device="cpu",
                            verbose=False)
    trainer.n_sub_batches = S
    return trainer


def test_load_base_network_splices_the_backbone(tmp_path):
    donor = _port_model()
    donor.reset_parameters(torch.Generator().manual_seed(11))
    port_file = checkpoint.save(str(tmp_path / "donor.pt"),
                                donor.state_dict())
    jmodel = jheads.CNNLinearNetwork(breath_block=jdn.densenet18())
    jparams = jmodel.init({"params": jax.random.PRNGKey(5)},
                          jnp.zeros((2, S, 1, L)), None, True)["params"]
    npz_file = str(tmp_path / "donor.npz")
    np.savez(npz_file, **_flat(jparams))
    for path, want in ((port_file, donor.state_dict()),
                       (npz_file, transplant(_flat(jparams)))):
        trainer = _trainer(tmp_path, load_base_network=path)
        state = trainer.new_state(0)
        fresh = {k: v.clone() for k, v in state.model.state_dict().items()}
        trainer.load_base_network(state, path)
        for k, v in state.model.state_dict().items():
            expect = want[k] if k.startswith("breath_block.") else fresh[k]
            assert torch.equal(v, expect), k
        assert not torch.equal(fresh["breath_block.conv0.weight"],
                               want["breath_block.conv0.weight"])
    with pytest.raises(ValueError, match="breath_block"):
        checkpoint.save(str(tmp_path / "head.pt"),
                        {"head.bias": torch.zeros(2)})
        trainer.load_base_network(state, str(tmp_path / "head.pt"))


def _jax_frozen_step(data, target, mask):
    """One JAX step with ``freeze_backbone``: (params before, after, raw
    gradient), flat."""
    jmodel = jheads.CNNLinearNetwork(breath_block=jdn.densenet18())
    tx = jsteps.make_optimizer("sgd", learning_rate=0.001,
                               weight_decay=0.0001, clip_grad=True,
                               clip_val=0.01)
    state = jsteps.create_train_state(
        jmodel, tx, {"data": data}, jax.random.PRNGKey(0))
    frozen_tx = jsteps.freeze_backbone(tx, state.params)
    state = state.replace(opt_state=frozen_tx.init(state.params))
    mu, std = jnp.asarray(MU), jnp.asarray(STD)

    def transform(d):
        return jpipeline.transform_batch(d, mu, std,
                                         jnp.zeros((1, 6), jnp.float32))

    train, _, _, _ = jsteps.make_train_step(
        jmodel, frozen_tx, jlosses.bce_with_logits, transform=transform,
        dropout_active=False)
    batch = {"data": jnp.asarray(data), "target": jnp.asarray(target)}

    def loss_of(params):
        with jbn_row_mask(jnp.repeat(jnp.asarray(mask), S)):
            out = jmodel.apply({"params": params}, transform(batch["data"]),
                               None, True)
        return jlosses.bce_with_logits(out, batch["target"],
                                       jnp.asarray(mask))

    grads = jax.grad(loss_of)(state.params)
    before = _flat(state.params)
    after, _ = train(state, batch, jnp.asarray(mask))
    return before, _flat(after.params), _flat(grads)


def test_freeze_base_network(tmp_path):
    data, _, target, mask = _inputs(7)
    before, after, grads = _jax_frozen_step(data, target, mask)
    # the JAX package's fault, pinned: its masked-out backbone moves by
    # the raw (unclipped) gradient
    backbone = [k for k in before if k.startswith("breath_block/")]
    assert max(np.abs(grads[k]).max() for k in backbone) > 1e-3
    for k in backbone:
        np.testing.assert_allclose(after[k] - before[k], grads[k],
                                   atol=1e-5, rtol=1e-3, err_msg=k)

    trainer = _trainer(tmp_path, freeze_base_network=True)
    state = trainer.new_state(0)
    state.model.load_state_dict(transplant(before))
    trained = [n for n, p in state.model.named_parameters()
               if p.requires_grad]
    assert trained == ["head.weight", "head.bias"]
    assert len(state.optimizer.params) == 2
    init = {k: v.clone() for k, v in state.model.state_dict().items()}
    step, _ = make_train_step(
        bce_with_logits, transform=lambda d: transform_batch(
            d, torch.from_numpy(MU), torch.from_numpy(STD)),
        dropout_active=False)
    t = [torch.from_numpy(x) for x in (data, target, mask)]
    step(state, *t)
    head_update = {k: (state.model.state_dict()[k] - init[k]).numpy()
                   for k in ("head.weight", "head.bias")}
    want = transplant({k: after[k] - before[k] for k in after
                       if k.startswith("Dense_0/")})
    for k, update in head_update.items():
        assert np.abs(update).max() > 1e-6
        np.testing.assert_allclose(update, want[k].numpy(), atol=1e-9,
                                   rtol=0, err_msg=k)
    for _ in range(2):
        step(state, *t)
    for k, v in state.model.state_dict().items():
        assert torch.equal(v, init[k]) == k.startswith("breath_block."), k
