"""The sparse 3D CNN of EZ-SP's point encoder: submanifold convolutions
over the host-built rulebook (`ops/voxel_conv.py`).

Counterpart of `SparseConvBlock` and `SparseCNN` in
`superpoint_transformer_tpu/nn/sparse.py`, with the flax names as module
names (`block_<i>`, its `GraphNorm_0`, `InstanceNorm_0` or
`LayerNorm_0`), so that `utils/jax_params.py`
loads the JAX parameters: a block's flax `kernel` [K^3 * C, D] is its
`weight` [D, K^3 * C]. A convolution is one gather of the K^3 neighbor
rows of every voxel (an embedding lookup, `ops/segment.py:gather_rows`,
whose backward sums the many cotangents of a voxel in parallel) and one
matmul; an empty site (-1) contributes zero. Everything computes in f32,
as the JAX `PartitionModel` does.
"""
import torch
import torch.nn.functional as F
from torch import nn

from ..ops.segment import gather_rows
from .mlp import XAVIER_GAIN_LEAKY, leaky_relu
from .norm import GraphNorm, InstanceNorm, LayerNorm

__all__ = ['SparseConvBlock', 'SparseCNN', 'KERNEL_VOLUME']

# the rulebook's sites: EZ-SP's cubic kernel of size 3
KERNEL_VOLUME = 27

# norm name -> (class, flax name of the unnamed norm submodule)
_NORMS = {'graph': (GraphNorm, 'GraphNorm_0'),
          'instance': (InstanceNorm, 'InstanceNorm_0'),
          'layer': (LayerNorm, 'LayerNorm_0')}


class SparseConvBlock(nn.Module):
    """conv -> norm -> LeakyReLU. `norm` is 'graph' (GraphNorm),
    'instance', 'layer', or None / 'none' (a bias instead); the JAX
    block's residual and activation switches are left out: no
    configuration sets them. The weight is xavier-uniform with the
    leaky-relu gain, drawn on the CPU from `generator` (the JAX
    initializer's law)."""

    def __init__(self, in_channels, out_channels, norm='graph',
                 num_graphs=1, device=None, generator=None):
        super().__init__()
        if norm not in (None, 'none') and norm not in _NORMS:
            raise ValueError(f'SparseConvBlock: unknown norm {norm!r}')
        self.weight = nn.Parameter(torch.empty(
            out_channels, KERNEL_VOLUME * in_channels, device=device))
        self.init_from(generator)
        self.norm_name = None
        if norm in _NORMS:
            cls, self.norm_name = _NORMS[norm]
            self.add_module(self.norm_name, cls(
                out_channels, num_graphs=num_graphs, device=device))
        else:
            self.bias = nn.Parameter(torch.zeros(out_channels,
                                                 device=device))

    @torch.no_grad()
    def init_from(self, generator):
        """Draw the weight again from `generator` (on the CPU)."""
        out_channels, fan_in = self.weight.shape
        a = XAVIER_GAIN_LEAKY * (6.0 / (fan_in + out_channels)) ** 0.5
        self.weight.copy_(torch.empty(out_channels, fan_in).uniform_(
            -a, a, generator=generator))

    def forward(self, x, nbr_idx, batch=None, mask=None):
        n, c = x.shape
        k = nbr_idx.shape[1]
        if k * c != self.weight.shape[1]:
            raise ValueError(
                f'SparseConvBlock: {c} input channels over {k} kernel '
                f'sites, the weight takes {self.weight.shape[1]}')
        valid = nbr_idx >= 0
        gathered = gather_rows(x, nbr_idx.clamp(0, n - 1)) \
            * valid[..., None].to(x.dtype)
        # bf16 features (a bf16 SPT's batch) meet the f32 weight in f32,
        # as the JAX einsum promotes them
        y = F.linear(gathered.reshape(n, k * c).to(self.weight.dtype),
                     self.weight)
        if self.norm_name is not None:
            y = getattr(self, self.norm_name)(y, batch=batch, mask=mask)
        else:
            y = y + self.bias
        y = leaky_relu(y)
        if mask is not None:
            y = y * mask[:, None].to(y.dtype)
        return y


class SparseCNN(nn.Module):
    """A stack of SparseConvBlocks over one kernel-neighbor table (one
    kernel size and dilation, as in EZ-SP). `channels` are the blocks'
    output widths; `in_channels` the input's. Without `last_norm` the
    last block has a bias in place of its norm."""

    def __init__(self, in_channels, channels, norm='graph', last_norm=True,
                 num_graphs=1, device=None, generator=None):
        super().__init__()
        self.channels = [int(c) for c in channels]
        prev = int(in_channels)
        for i, ch in enumerate(self.channels):
            last = i == len(self.channels) - 1
            self.add_module(f'block_{i}', SparseConvBlock(
                prev, ch, norm=norm if (last_norm or not last) else None,
                num_graphs=num_graphs, device=device, generator=generator))
            prev = ch

    @property
    def out_dim(self):
        return self.channels[-1]

    def forward(self, x, nbr_idx, batch=None, mask=None):
        for i in range(len(self.channels)):
            x = getattr(self, f'block_{i}')(x, nbr_idx, batch=batch,
                                            mask=mask)
        return x
