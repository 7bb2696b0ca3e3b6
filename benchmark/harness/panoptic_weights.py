"""The weights of a panoptic run: the backbone's and heads' parameters
and the edge-affinity head's (`reference/panoptic.py:param_shapes`),
drawn from the run's seed on its device in one call, in the same way as
`weights.py:draw_weights` (xavier-uniform ranges with the leaky-ReLU gain
for the matrices, 0 +- 0.1 for the biases, 1 +- 0.1 for the norms'
scales), named as the program's `state_dict` names them. Both sides get
the same tensors."""
import math

import torch

from ..reference.panoptic import param_shapes
from .weights import _range

__all__ = ['draw_panoptic_weights']


def draw_panoptic_weights(m, seed, device):
    """{name: float32 tensor} of every parameter of the panoptic model of
    section `m`, from one uniform draw of a generator on `device` seeded
    with `seed`."""
    shapes = param_shapes(m)
    sizes = [math.prod(s) for _, s in shapes]
    offs, halves = zip(*(_range(n, s) for n, s in shapes))
    g = torch.Generator(device=device)
    g.manual_seed(int(seed) % (2 ** 63))
    u = torch.rand(sum(sizes), generator=g, device=device) * 2 - 1
    off = torch.repeat_interleave(torch.tensor(offs, device=device),
                                  torch.tensor(sizes, device=device))
    half = torch.repeat_interleave(torch.tensor(halves, device=device),
                                   torch.tensor(sizes, device=device))
    flat = (off + half * u).float()
    return {n: t.view(s) for (n, s), t in
            zip(shapes, torch.split(flat, sizes))}
