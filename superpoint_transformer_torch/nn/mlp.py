"""MLP / FFN / Classifier over [N, C] node features.

Counterpart of `superpoint_transformer_tpu/nn/mlp.py`. Submodules carry
the flax names (`linear_0`, `norm_0`, ..., `classifier`), so a flax
parameter path is a `state_dict` key (see `utils/jax_params.py`).
"""
import torch
import torch.nn.functional as F
from torch import nn

from ..ops.graph_norm import LEAKY_SLOPE
from .dropout import Dropout, DropoutRNG
from .norm import GraphNorm, make_norm

__all__ = ['MLP', 'FFN', 'Classifier', 'leaky_relu', 'init_weights',
           'resolve_dtype', 'dropout']

# torch.nn.init.calculate_gain('leaky_relu'), as the JAX package's
# xavier_uniform_gain uses it
XAVIER_GAIN_LEAKY = 1.4140664


def leaky_relu(x):
    return F.leaky_relu(x, negative_slope=LEAKY_SLOPE)


def resolve_dtype(compute_dtype):
    """The dtype a module computes its matmuls in: bf16 for
    'bf16'/'bfloat16', f32 otherwise."""
    if compute_dtype in ('bf16', 'bfloat16'):
        return torch.bfloat16
    return torch.float32


def linear(layer, x, dtype):
    """`layer(x)` with input, weight and bias in `dtype` (a flax Dense
    with `dtype=` set)."""
    bias = None if layer.bias is None else layer.bias.to(dtype)
    return F.linear(x.to(dtype), layer.weight.to(dtype), bias)


@torch.no_grad()
def init_weights(module, generator):
    """Initialize every Linear of `module` as the JAX package does:
    torch-style xavier-uniform with the leaky-relu gain, zero bias; the
    sparse convolutions' weights likewise; and the learnt query of an
    attentive pool, truncated normal of std 0.02.
    Values are drawn on the CPU from `generator` and copied to each
    parameter's device, so the result does not depend on the device."""
    for m in module.modules():
        if hasattr(m, 'init_from'):      # a sparse convolution
            m.init_from(generator)
        if getattr(m, 'learnt_queries', False):
            q = nn.init.trunc_normal_(torch.empty(m.q.shape), std=0.02,
                                      a=-0.04, b=0.04, generator=generator)
            m.q.copy_(q)
        if isinstance(m, nn.Linear):
            fan_out, fan_in = m.weight.shape
            a = XAVIER_GAIN_LEAKY * (6.0 / (fan_in + fan_out)) ** 0.5
            w = torch.empty(fan_out, fan_in).uniform_(-a, a,
                                                      generator=generator)
            m.weight.copy_(w)
            if m.bias is not None:
                m.bias.zero_()
    return module


def dropout(rate, rng):
    """A `Dropout` of `rate` drawing from `rng` (a fresh stream when
    None), or None at rate 0."""
    if not rate:
        return None
    return Dropout(rate, rng if rng is not None else DropoutRNG())


class MLP(nn.Module):
    """Linear-Norm-LeakyReLU stack; `norm` is 'graph' (GraphNorm, every
    config's), 'layer', 'instance', 'group', 'batch' or None (no norm: the
    Linear layers take a bias, as in the JAX MLP, where they drop it
    because a norm follows). `drop` is a dropout rate on the output, in
    training, drawn from `rng` (`nn/dropout.py`). Under bf16 the chain
    runs in bf16 and the output is cast back to f32."""

    def __init__(self, dims, norm='graph', drop=None, num_graphs=64,
                 compute_dtype=None, shard_group=None, rng=None,
                 device=None):
        super().__init__()
        self.dims = list(dims)
        self.dtype = resolve_dtype(compute_dtype)
        for i in range(len(dims) - 1):
            self.add_module(f'linear_{i}', nn.Linear(
                dims[i], dims[i + 1], bias=norm is None, device=device))
            if norm is not None:
                self.add_module(f'norm_{i}', make_norm(
                    norm, dims[i + 1], num_graphs=num_graphs,
                    shard_group=shard_group, device=device))
        self.drop = dropout(drop, rng)

    @property
    def out_dim(self):
        return self.dims[-1]

    def forward(self, x, batch=None, mask=None):
        x = x.to(self.dtype)
        for i in range(len(self.dims) - 1):
            x = linear(getattr(self, f'linear_{i}'), x, self.dtype)
            norm = getattr(self, f'norm_{i}', None)
            if isinstance(norm, GraphNorm):
                # the activation inside the norm's kernels where they run
                x = norm(x, batch=batch, mask=mask, leaky=True)
                continue
            if norm is not None:
                x = norm(x, batch=batch, mask=mask)
            x = leaky_relu(x)
        if self.drop is not None:
            x = self.drop(x)
        return x.to(torch.float32)


class FFN(nn.Module):
    """Transformer feed-forward: Linear-LeakyReLU-Linear, in f32, and a
    dropout of rate `drop` on the output in training."""

    def __init__(self, dim, hidden_dim=None, out_dim=None, drop=None,
                 rng=None, device=None):
        super().__init__()
        hidden = hidden_dim or dim
        self.linear_0 = nn.Linear(dim, hidden, device=device)
        self.linear_1 = nn.Linear(hidden, out_dim or dim, device=device)
        self.drop = dropout(drop, rng)

    def forward(self, x):
        x = self.linear_1(leaky_relu(self.linear_0(x)))
        return x if self.drop is None else self.drop(x)


class Classifier(nn.Module):
    """Plain linear head, in f32."""

    def __init__(self, in_dim, num_classes, device=None):
        super().__init__()
        self.classifier = nn.Linear(in_dim, num_classes, device=device)

    def forward(self, x):
        return self.classifier(x)
