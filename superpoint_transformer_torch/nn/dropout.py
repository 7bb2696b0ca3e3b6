"""Dropout and DropPath, drawn from one seeded random stream per model.

Counterparts of flax's `nn.Dropout` (as the JAX MLP, FFN and attention
apply it) and of `DropPath` in `superpoint_transformer_tpu/nn/
transformer.py`. JAX draws from the `dropout` PRNG stream the caller
passes; here every module of a model draws from the model's one
`DropoutRNG`, a `torch.Generator` per device seeded from one seed, so
that reseeding it (`DropoutRNG.manual_seed`) repeats every mask. The masks
cannot match JAX's bits; the law is the same: an element (a node, for
DropPath) is kept with probability 1 - rate and scaled by 1 / (1 - rate).
Outside training, or at rate 0, both are the identity.
"""
import torch
from torch import nn

__all__ = ['DropoutRNG', 'Dropout', 'DropPath']


class DropoutRNG:
    """The random stream of a model's dropout draws: one
    `torch.Generator` per device, each seeded with `seed` when first
    used. Pickles without its generators (a copy restarts from `seed`)."""

    def __init__(self, seed=0):
        self.seed = int(seed)
        self._generators = {}

    def manual_seed(self, seed):
        """Restart every stream from `seed`."""
        self.seed = int(seed)
        self._generators = {}

    def generator(self, device):
        key = str(torch.device(device))
        g = self._generators.get(key)
        if g is None:
            g = torch.Generator(device=device)
            g.manual_seed(self.seed)
            self._generators[key] = g
        return g

    def keep(self, shape, rate, device):
        """A bool mask of `shape`, each entry True with probability
        1 - rate."""
        u = torch.rand(shape, generator=self.generator(device),
                       device=device)
        return u >= rate

    def __getstate__(self):
        return {'seed': self.seed, '_generators': {}}


def _drop(x, keep, rate):
    return torch.where(keep, x / (1.0 - rate), torch.zeros_like(x))


class Dropout(nn.Module):
    """Element-wise dropout of rate `rate` in training."""

    def __init__(self, rate, rng):
        super().__init__()
        self.rate = float(rate or 0.0)
        self.rng = rng

    def forward(self, x):
        if not self.training or self.rate <= 0:
            return x
        return _drop(x, self.rng.keep(x.shape, self.rate, x.device),
                     self.rate)


class DropPath(nn.Module):
    """Stochastic depth: in training, a whole residual branch of a node
    (a row of `x`) is dropped with probability `rate`."""

    def __init__(self, rate, rng):
        super().__init__()
        self.rate = float(rate or 0.0)
        self.rng = rng

    def forward(self, x):
        if not self.training or self.rate <= 0:
            return x
        return _drop(x, self.rng.keep((x.shape[0], 1), self.rate, x.device),
                     self.rate)
