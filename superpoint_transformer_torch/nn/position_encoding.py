"""Position encodings / injections (reference
src/nn/position_encoding.py:17-144): ways of combining node positions
(normalized by UnitSphereNorm upstream) with node features before a
stage's input MLP. Counterpart of
`superpoint_transformer_tpu/nn/position_encoding.py`.

Submodules and parameters carry the flax names (`proj`, `mlp`, `freq`),
so `utils/jax_params.load_jax_params` carries a flax tree across. Where
flax infers widths from the first call, these modules take them at
construction: `pos_dim` (the position width) and `x_dim` (the feature
width). With `x=None` the additive and MLP injections return `pos`, as
the JAX modules do.
"""
import math

import torch
from torch import nn

from .mlp import MLP

__all__ = ['CatInjection', 'AdditiveInjection', 'MLPInjection',
           'FourierInjection', 'LearnableFourierInjection',
           'injection_factory']


class CatInjection(nn.Module):
    """x <- [pos | x] (the reference default)."""

    def forward(self, pos, x, batch=None, mask=None):
        return pos if x is None else torch.cat([pos, x], 1)


class AdditiveInjection(nn.Module):
    """x <- x + Linear(pos) (pos projected to the feature width)."""

    def __init__(self, pos_dim, x_dim, device=None):
        super().__init__()
        self.proj = nn.Linear(pos_dim, x_dim, bias=False, device=device)

    def forward(self, pos, x, batch=None, mask=None):
        return pos if x is None else x + self.proj(pos)


class MLPInjection(nn.Module):
    """x <- x + MLP(pos), the MLP normed by GraphNorm."""

    def __init__(self, pos_dim, x_dim, hidden=32, num_graphs=64,
                 device=None):
        super().__init__()
        self.mlp = MLP((pos_dim, hidden, x_dim), num_graphs=num_graphs,
                       device=device)

    def forward(self, pos, x, batch=None, mask=None):
        if x is None:
            return pos
        return x + self.mlp(pos, batch=batch, mask=mask)


class FourierInjection(nn.Module):
    """x <- [fourier(pos) | x]: fixed log-spaced sin/cos features per
    axis (reference FourierPositionEncoding)."""

    def __init__(self, num_bands=8, max_freq=32.0):
        super().__init__()
        self.num_bands = num_bands
        self.max_freq = max_freq

    def forward(self, pos, x, batch=None, mask=None):
        freqs = torch.exp(torch.linspace(
            0.0, math.log(self.max_freq), self.num_bands,
            device=pos.device, dtype=pos.dtype))
        ang = pos[:, :, None] * freqs[None, None, :] * math.pi
        enc = torch.cat([ang.sin(), ang.cos()], -1).reshape(pos.shape[0], -1)
        return enc if x is None else torch.cat([enc, x], 1)


class LearnableFourierInjection(nn.Module):
    """x <- [sin/cos(pos @ W) | x] with a learned projection W (Li et al.
    2021, learnable Fourier features), W drawn from N(0, scale^2)."""

    def __init__(self, pos_dim, num_features=16, scale=10.0,
                 generator=None, device=None):
        super().__init__()
        self.num_features = num_features
        self.scale = scale
        self.freq = nn.Parameter(torch.empty(pos_dim, num_features,
                                             device=device))
        self.init_from(generator)

    @torch.no_grad()
    def init_from(self, generator):
        """Draw W again from `generator` (on the CPU)."""
        self.freq.copy_(torch.randn(self.freq.shape, generator=generator)
                        * self.scale)

    def forward(self, pos, x, batch=None, mask=None):
        ang = pos @ self.freq
        enc = torch.cat([ang.sin(), ang.cos()], 1) \
            / math.sqrt(self.num_features)
        return enc if x is None else torch.cat([enc, x], 1)


def injection_factory(name):
    return {
        'cat': CatInjection, 'additive': AdditiveInjection,
        'mlp': MLPInjection, 'fourier': FourierInjection,
        'learnable_fourier': LearnableFourierInjection,
    }[name]
