"""Initial weights from the seed, made on the device in a few calls.

Every leaf the network's reference module lists in ``param_spec`` is
filled by its kind: normal leaves (convolutions with std
sqrt(2 / (k * out)), dense kernels with 1 / sqrt(fan in)) are slices of
one normal draw, orthogonal ones (an LSTM's recurrent kernels) the Q
factors of one batched QR of a second draw, norm scales 1 and biases 0,
and a leaf with an init of the module's own (``("custom", fn)``) what
``fn(shape, generator, device)`` returns, called in the spec's order
after those two draws.  They are float32, the master type the program
trains.  The same tensors go to the program and to the reference.
"""
import math

import torch

from benchmark.reference import networks


def make_weights(network, n_sub_batches, seed, device):
    spec = networks.load(network).param_spec(n_sub_batches)
    gen = torch.Generator(device=device).manual_seed(int(seed))
    normal = [(n, s, i[1]) for n, s, i in spec if i[0] == "normal"]
    ortho = [(n, s) for n, s, i in spec if i[0] == "orthogonal"]
    total = sum(math.prod(s) for _, s, _ in normal)
    draw = torch.randn(total, generator=gen, device=device)
    out, at = {}, 0
    for name, shape, std in normal:
        size = math.prod(shape)
        out[name] = (draw[at:at + size] * std).reshape(shape)
        at += size
    if ortho:
        shape = ortho[0][1]
        q, r = torch.linalg.qr(torch.randn((len(ortho),) + shape,
                                           generator=gen, device=device))
        q = q * torch.sign(torch.diagonal(r, dim1=-2, dim2=-1))[:, None, :]
        for k, (name, _) in enumerate(ortho):
            out[name] = q[k].contiguous()
    for name, shape, init in spec:
        if init[0] == "ones":
            out[name] = torch.ones(shape, device=device)
        elif init[0] == "zeros":
            out[name] = torch.zeros(shape, device=device)
        elif init[0] == "custom":
            out[name] = init[1](shape, gen, device).float()
            if tuple(out[name].shape) != tuple(shape):
                raise ValueError("{}: its init gave the shape {}, not {}"
                                 .format(name, tuple(out[name].shape),
                                         tuple(shape)))
        elif init[0] not in ("normal", "orthogonal"):
            raise ValueError("{}: unknown init {!r}".format(name, init[0]))
    return {name: out[name] for name, _, _ in spec}
