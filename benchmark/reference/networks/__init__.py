"""Each network's plain reference past the shared backbone, one module a
network, named as the configuration's ``flags.network`` names it:
``reference/networks/<network>.py``.  ``load`` finds it by that name and
nothing else in the benchmark names a network.

A module states:

- ``STEP``: what one train or test step holds.  ``"samples"``: a batch of
  B samples, each a window of S breaths, whose B*S breaths the backbone
  normalizes together (pad samples masked out of the statistics); the
  whole step is one autograd graph.  ``"patient"``: one patient's W
  windows, each normalized over its own S breaths; the backbone runs in
  blocks of windows and the step splits at its per-breath features;
- ``param_spec(n_sub_batches, in_channels=1)``: [(name, shape, init)] of
  every leaf, the backbone's (``model.backbone_spec``) first.  ``init``
  is ``("normal", std)``, ``("orthogonal",)``, ``("ones",)``,
  ``("zeros",)`` or ``("custom", fn)``: ``fn(shape, generator, device)``
  returns the float32 leaf, a fixed table or a draw from the run's
  weight generator made after the others (``benchmark/weights.py``);
- ``logits(p, feats, quant=None)``: the (N, S, F) per-breath features of
  a step's N samples or windows -> its (N, 2) logits;
- optionally ``loss_grads(p, feats, target, weights, quant=None)`` of a
  ``"patient"`` network: (loss, the features' gradient, {leaf: gradient}
  of the leaves past the backbone), the loss ``model.bce`` of the logits
  against ``target`` (W, 2) weighted by ``weights`` (W,).  A head that
  needs blocks or recomputation to fit gives its own; without one it is
  autograd through ``logits``.
"""
import importlib
import os

STEPS = ("samples", "patient")


def load(network):
    """The reference module of ``network``; raises, naming the file it
    looked for, where there is none."""
    name = "{}.{}".format(__name__, network)
    try:
        module = importlib.import_module(name)
    except ModuleNotFoundError as err:
        if err.name != name:
            raise
        raise ValueError("no reference for network {!r}: {} is missing"
                         .format(network, os.path.join(
                             os.path.dirname(__file__), network + ".py"))
                         ) from None
    if module.STEP not in STEPS:
        raise ValueError("{}: STEP is {!r}, not one of {}".format(
            name, module.STEP, STEPS))
    return module
