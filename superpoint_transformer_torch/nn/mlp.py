"""MLP / FFN / Classifier over [N, C] node features.

Counterpart of `superpoint_transformer_tpu/nn/mlp.py`. Submodules carry
the flax names (`linear_0`, `norm_0`, ..., `classifier`), so a flax
parameter path is a `state_dict` key (see `utils/jax_params.py`).
"""
import torch
import torch.nn.functional as F
from torch import nn

from .norm import GraphNorm

__all__ = ['MLP', 'FFN', 'Classifier', 'leaky_relu', 'init_weights',
           'resolve_dtype']

# torch.nn.init.calculate_gain('leaky_relu'), as the JAX package's
# xavier_uniform_gain uses it
XAVIER_GAIN_LEAKY = 1.4140664


def leaky_relu(x):
    return F.leaky_relu(x, negative_slope=0.01)


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
    torch-style xavier-uniform with the leaky-relu gain, zero bias.
    Values are drawn on the CPU from `generator` and copied to each
    parameter's device, so the result does not depend on the device."""
    for m in module.modules():
        if isinstance(m, nn.Linear):
            fan_out, fan_in = m.weight.shape
            a = XAVIER_GAIN_LEAKY * (6.0 / (fan_in + fan_out)) ** 0.5
            w = torch.empty(fan_out, fan_in).uniform_(-a, a,
                                                      generator=generator)
            m.weight.copy_(w)
            if m.bias is not None:
                m.bias.zero_()
    return module


class MLP(nn.Module):
    """Linear-GraphNorm-LeakyReLU stack (the Linear layers have no bias,
    since a norm follows). Under bf16 the chain runs in bf16 and the
    output is cast back to f32."""

    def __init__(self, dims, num_graphs=64, compute_dtype=None,
                 shard_group=None, device=None):
        super().__init__()
        self.dims = list(dims)
        self.dtype = resolve_dtype(compute_dtype)
        for i in range(len(dims) - 1):
            self.add_module(f'linear_{i}', nn.Linear(
                dims[i], dims[i + 1], bias=False, device=device))
            self.add_module(f'norm_{i}', GraphNorm(
                dims[i + 1], num_graphs=num_graphs, shard_group=shard_group,
                device=device))

    @property
    def out_dim(self):
        return self.dims[-1]

    def forward(self, x, batch=None, mask=None):
        x = x.to(self.dtype)
        for i in range(len(self.dims) - 1):
            x = linear(getattr(self, f'linear_{i}'), x, self.dtype)
            x = leaky_relu(getattr(self, f'norm_{i}')(x, batch=batch,
                                                      mask=mask))
        return x.to(torch.float32)


class FFN(nn.Module):
    """Transformer feed-forward: Linear-LeakyReLU-Linear, in f32."""

    def __init__(self, dim, hidden_dim=None, out_dim=None, device=None):
        super().__init__()
        hidden = hidden_dim or dim
        self.linear_0 = nn.Linear(dim, hidden, device=device)
        self.linear_1 = nn.Linear(hidden, out_dim or dim, device=device)

    def forward(self, x):
        return self.linear_1(leaky_relu(self.linear_0(x)))


class Classifier(nn.Module):
    """Plain linear head, in f32."""

    def __init__(self, in_dim, num_classes, device=None):
        super().__init__()
        self.classifier = nn.Linear(in_dim, num_classes, device=device)

    def forward(self, x):
        return self.classifier(x)
