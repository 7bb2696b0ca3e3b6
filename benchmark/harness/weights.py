"""The model weights of a run, drawn from its seed on the run's device in
one call and shaped into the parameters that the reference names
(`reference/spt.py:param_shapes`), the same names as the program's
`state_dict`. Both sides get the same tensors."""
import math

import torch

from ..reference.spt import param_shapes

__all__ = ['draw_weights']

GAIN = 1.4140664     # the leaky-ReLU gain of a xavier-uniform init


def _range(name, shape):
    """(offset, half-width) of the uniform draw of one parameter."""
    leaf = name.rsplit('.', 1)[1]
    if leaf == 'weight' and len(shape) == 2:
        fan_out, fan_in = shape
        return 0.0, GAIN * math.sqrt(6.0 / (fan_in + fan_out))
    if leaf in ('weight', 'mean_scale'):
        return 1.0, 0.1
    return 0.0, 0.1


def draw_weights(m, seed, device):
    """{name: float32 tensor} of every parameter of model section `m`,
    from one uniform draw of a generator on `device` seeded with
    `seed`."""
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
