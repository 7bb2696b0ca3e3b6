"""The index-based norms (GraphNorm, LayerNorm, InstanceNorm,
GroupNorm), BatchNorm and unit-sphere position normalization over
padded levels.

Counterpart of `superpoint_transformer_tpu/nn/norm.py`. Statistics
ignore padded rows: `mask` zeroes them by multiplication, and their
graph id (-1) or segment index (== num_segments) sends them to the
segment ops' dump row. `make_norm` builds a norm by its config name.

Under graph-partition sharding (`parallel/shard_nag.py`) a graph's nodes
lie on several ranks: `shard_group` (a process group, where JAX has
`shard_axis`) sums the per-graph statistics over the ranks, and takes
the min and max of the positions over them. The JAX GroupNorm takes no
`shard_axis` (its statistics stay per shard); the port's sums them over
the group like the other norms.
"""
import torch
import torch.nn.functional as F
from torch import nn

from ..ops.graph_norm import (LEAKY_SLOPE, MAX_GRAPHS, graph_norm,
                              scale_shift)
from ..ops.segment import (segment_sum, segment_count, segment_max,
                           gather_rows_small)
from ..parallel.collectives import all_reduce_max, all_reduce_sum
from ..utils.profiling import annotate


def _group_sum(x, group):
    return x if group is None else all_reduce_sum(x, group)


def _affine(num_features, device):
    return (nn.Parameter(torch.ones(num_features, device=device)),
            nn.Parameter(torch.zeros(num_features, device=device)))


def _graph_index(batch, x):
    if batch is None:
        return torch.zeros(x.shape[0], dtype=torch.long, device=x.device)
    return batch

__all__ = ['GraphNorm', 'LayerNorm', 'InstanceNorm', 'GroupNorm',
           'BatchNorm', 'make_norm', 'unit_sphere_norm', 'UnitSphereNorm',
           'INDEX_BASED_NORMS']


class GraphNorm(nn.Module):
    """PyG GraphNorm: per-graph mean (scaled by the learnable
    `mean_scale`) and variance normalization, then an affine map.

    Without gradients, on a CUDA f32 or bf16 `x`, unsharded and over at
    most `ops/graph_norm.py:MAX_GRAPHS` graphs, the forward is that
    module's three kernels (`graph_norm`); otherwise it is PyTorch ops
    (the segment sums and gathers). `leaky` applies the MLP's LeakyReLU
    to the output: inside the kernels, before the rounding to x's dtype,
    or after the plain path. Every forward runs in an `spt.norm` span and
    counts in `graph_norm.calls`, those that take the kernels in
    `graph_norm.fused`."""

    def __init__(self, num_features, num_graphs=64, eps=1e-5,
                 shard_group=None, device=None):
        super().__init__()
        self.num_features = num_features
        self.num_graphs = num_graphs
        self.eps = eps
        self.shard_group = shard_group
        self.weight = nn.Parameter(torch.ones(num_features, device=device))
        self.bias = nn.Parameter(torch.zeros(num_features, device=device))
        self.mean_scale = nn.Parameter(
            torch.ones(num_features, device=device))

    def forward(self, x, batch=None, mask=None, leaky=False):
        graph_norm.calls += 1
        with annotate('spt.norm'):
            if (x.is_cuda and not torch.is_grad_enabled()
                    and self.shard_group is None
                    and x.dtype in (torch.float32, torch.bfloat16)
                    and self.num_graphs <= MAX_GRAPHS):
                graph_norm.fused += 1
                return graph_norm(
                    x.contiguous(), None if batch is None else batch.long(),
                    None if mask is None else mask.bool(), self.weight,
                    self.bias, self.mean_scale, self.eps, self.num_graphs,
                    leaky=leaky)
            y = self._plain(x, batch, mask)
            return F.leaky_relu(y, LEAKY_SLOPE) if leaky else y

    def _plain(self, x, batch, mask):
        if batch is None:
            batch = torch.zeros(x.shape[0], dtype=torch.long,
                                device=x.device)
        g, C = self.num_graphs, x.shape[1]
        in_dtype = x.dtype
        xm = x if mask is None else x * mask[:, None].to(x.dtype)
        # single pass over concat(x, x^2), squared in the input dtype
        # and summed in f32: E[(x - a*mu)^2] = E[x^2] - 2a*mu*E[x] + (a*mu)^2
        s12 = segment_sum(torch.cat([xm, xm * xm], 1), batch, g,
                          acc_dtype=torch.float32)
        n = segment_count(batch, g, mask=mask)
        if self.shard_group is not None:
            s12 = all_reduce_sum(s12, self.shard_group)
            n = all_reduce_sum(n, self.shard_group)
        sc, sh = scale_shift(s12[:, :C], s12[:, C:],
                             n.to(torch.float32)[:, None], self.weight,
                             self.bias, self.mean_scale, self.eps)
        sc = gather_rows_small(sc, batch, g)
        sh = gather_rows_small(sh, batch, g)
        return (x.to(torch.float32) * sc + sh).to(in_dtype)


class LayerNorm(nn.Module):
    """PyG LayerNorm in graph mode: each node normalized by the mean and
    variance of its graph over all nodes and channels, then a
    per-channel affine map. `mode='node'` normalizes each node over its
    own channels."""

    def __init__(self, num_features, num_graphs=64, eps=1e-5, mode='graph',
                 shard_group=None, device=None):
        super().__init__()
        self.num_features, self.num_graphs = num_features, num_graphs
        self.eps, self.mode, self.shard_group = eps, mode, shard_group
        self.weight, self.bias = _affine(num_features, device)

    def forward(self, x, batch=None, mask=None):
        if self.mode == 'node':
            mean = x.mean(-1, keepdim=True)
            var = ((x - mean) ** 2).mean(-1, keepdim=True)
            return (x - mean) / torch.sqrt(var + self.eps) * self.weight \
                + self.bias
        batch = _graph_index(batch, x)
        g, C = self.num_graphs, self.num_features
        n = _group_sum(segment_count(batch, g, mask=mask), self.shard_group)
        n = (n.to(x.dtype) * C).clamp(min=1)
        xm = x if mask is None else x * mask[:, None].to(x.dtype)
        s12 = _group_sum(segment_sum(torch.cat([xm, xm * xm], 1), batch, g,
                                     acc_dtype=torch.float32),
                         self.shard_group)
        mean = s12[:, :C].sum(-1) / n
        ex2 = s12[:, C:].sum(-1) / n
        inv = 1.0 / torch.sqrt((ex2 - mean * mean).clamp(min=0.0)
                               + self.eps)
        sc = gather_rows_small(inv[:, None], batch, g)
        sh = gather_rows_small((-mean * inv)[:, None], batch, g)
        return (x * sc + sh) * self.weight + self.bias


class InstanceNorm(nn.Module):
    """Per-graph, per-channel mean and variance normalization, then an
    affine map (output in f32)."""

    def __init__(self, num_features, num_graphs=64, eps=1e-5,
                 shard_group=None, device=None):
        super().__init__()
        self.num_features, self.num_graphs = num_features, num_graphs
        self.eps, self.shard_group = eps, shard_group
        self.weight, self.bias = _affine(num_features, device)

    def forward(self, x, batch=None, mask=None):
        batch = _graph_index(batch, x)
        g, C = self.num_graphs, self.num_features
        xm = x if mask is None else x * mask[:, None].to(x.dtype)
        s12 = _group_sum(segment_sum(torch.cat([xm, xm * xm], 1), batch, g,
                                     acc_dtype=torch.float32),
                         self.shard_group)
        n = _group_sum(segment_count(batch, g, mask=mask), self.shard_group)
        n = n.clamp(min=1).to(torch.float32)[:, None]
        mean = s12[:, :C] / n
        var = (s12[:, C:] / n - mean * mean).clamp(min=0.0)
        inv = 1.0 / torch.sqrt(var + self.eps)
        sc = gather_rows_small(inv * self.weight, batch, g)
        sh = gather_rows_small(self.bias - mean * inv * self.weight,
                               batch, g)
        return x.to(torch.float32) * sc + sh


class GroupNorm(nn.Module):
    """Graph-wise group normalization: the channels in `num_groups`
    groups, each normalized by its graph's mean and variance over the
    group's channels, then a per-channel affine map."""

    def __init__(self, num_features, num_groups=4, num_graphs=64, eps=1e-5,
                 shard_group=None, device=None):
        super().__init__()
        if num_features % num_groups:
            raise ValueError(f'GroupNorm: {num_features} channels in '
                             f'{num_groups} groups')
        self.num_features, self.num_groups = num_features, num_groups
        self.num_graphs, self.eps = num_graphs, eps
        self.shard_group = shard_group
        self.weight, self.bias = _affine(num_features, device)

    def forward(self, x, batch=None, mask=None):
        batch = _graph_index(batch, x)
        C, G, g = self.num_features, self.num_groups, self.num_graphs
        gc = C // G
        xg = x.reshape(-1, G, gc)
        n = _group_sum(segment_count(batch, g, mask=mask), self.shard_group)
        norm = n.clamp(min=1).to(x.dtype) * gc
        xm = xg if mask is None else xg * mask[:, None, None].to(x.dtype)
        mean = _group_sum(segment_sum(xm, batch, g), self.shard_group).sum(
            -1, keepdim=True) / norm[:, None, None]
        var = _group_sum(segment_sum(xm * xm, batch, g),
                         self.shard_group).sum(-1, keepdim=True) \
            / norm[:, None, None] - mean * mean
        inv = 1.0 / torch.sqrt(var.clamp(min=0.0) + self.eps)
        sc = gather_rows_small(inv.reshape(g, G), batch, g)
        sh = gather_rows_small((-mean * inv).reshape(g, G), batch, g)
        out = (xg * sc[..., None] + sh[..., None]).reshape(-1, C)
        return out * self.weight + self.bias


class BatchNorm(nn.Module):
    """Batch norm over the valid nodes, with running statistics (the
    buffers `mean` and `var`, the JAX `batch_stats`): in training each
    call normalizes by the batch's masked mean and biased variance and
    moves the running ones by `momentum` (running = momentum * running +
    (1 - momentum) * batch, over the masked count); in evaluation it
    normalizes by the running ones. `shard_group` sums the batch
    statistics over the ranks (sync batch norm)."""

    def __init__(self, num_features, momentum=0.9, eps=1e-5, num_graphs=1,
                 shard_group=None, device=None):
        super().__init__()
        self.num_features, self.momentum, self.eps = (num_features,
                                                      momentum, eps)
        self.num_graphs, self.shard_group = num_graphs, shard_group
        self.weight, self.bias = _affine(num_features, device)
        self.register_buffer('mean', torch.zeros(num_features,
                                                 device=device))
        self.register_buffer('var', torch.ones(num_features, device=device))

    def forward(self, x, batch=None, mask=None):
        if self.training:
            if mask is not None:
                m = mask.to(x.dtype)[:, None]
                s, ss, n = (x * m).sum(0), (x * x * m).sum(0), m.sum()
            else:
                s, ss = x.sum(0), (x * x).sum(0)
                n = torch.tensor(float(x.shape[0]), dtype=x.dtype,
                                 device=x.device)
            if self.shard_group is not None:
                s, ss, n = (all_reduce_sum(t, self.shard_group)
                            for t in (s, ss, n))
            n = n.clamp(min=1)
            mean = s / n
            var = (ss / n - mean * mean).clamp(min=0.0)
            with torch.no_grad():
                self.mean.copy_(self.momentum * self.mean
                                + (1 - self.momentum) * mean)
                self.var.copy_(self.momentum * self.var
                               + (1 - self.momentum) * var)
        else:
            mean, var = self.mean, self.var
        return (x - mean) / torch.sqrt(var + self.eps) * self.weight \
            + self.bias


_NORMS = {'graph': GraphNorm, 'graph_norm': GraphNorm, 'layer': LayerNorm,
          'instance': InstanceNorm, 'group': GroupNorm, 'batch': BatchNorm}


def make_norm(kind, num_features, num_graphs=64, shard_group=None,
              device=None):
    """The norm named `kind` ('graph', 'layer', 'instance', 'group' or
    'batch') over `num_features` channels."""
    if kind not in _NORMS:
        raise ValueError(f'unknown norm {kind!r}')
    return _NORMS[kind](num_features, num_graphs=num_graphs,
                        shard_group=shard_group, device=device)


def unit_sphere_norm(pos, super_index, num_super, node_size=None,
                     mask=None, indices_are_sorted=False, shard_group=None):
    """Normalize same-segment positions into a sphere of diameter 1.

    Returns (normalized pos [N, 3], per-segment diameter
    [num_super, 1]). Padded rows (mask False, or an out-of-range
    `super_index`) contribute nothing. `indices_are_sorted` says that
    `super_index` is non-decreasing (a level sorted by parent, its
    padded rows last). `shard_group`: the segments span the ranks of the
    group (the graphs of a sharded batch), whose extents and weighted
    sums are reduced over them."""
    big = torch.finfo(pos.dtype).max
    if mask is not None:
        # exile padded rows so they never win the min or the max
        m = mask[:, None]
        p_for_min = torch.where(m, pos, torch.full_like(pos, big))
        p_for_max = torch.where(m, pos, torch.full_like(pos, -big))
    else:
        p_for_min = p_for_max = pos
    # one max pass over concat(pos, -pos) gives both max and min; an
    # empty segment comes out as -inf / +inf
    mxmn = segment_max(torch.cat([p_for_max, -p_for_min], 1),
                       super_index, num_super)
    if shard_group is not None:
        # the max of -pos is minus the min: one collective for both
        mxmn = all_reduce_max(mxmn, shard_group)
    mx, mn = mxmn[:, :3], -mxmn[:, 3:]
    valid_seg = mx[:, 0] > -big * 0.5
    diameter = torch.where(valid_seg, (mx - mn).amax(1),
                           torch.zeros_like(mx[:, 0]))

    w = (torch.ones(pos.shape[0], dtype=pos.dtype, device=pos.device)
         if node_size is None else node_size)
    if mask is not None:
        w = w * mask.to(w.dtype)
    sums = segment_sum(torch.cat([pos * w[:, None], w[:, None]], 1),
                       super_index, num_super,
                       indices_are_sorted=indices_are_sorted)
    if shard_group is not None:
        sums = all_reduce_sum(sums, shard_group)
    center = sums[:, :3] / sums[:, 3].clamp(min=1e-12)[:, None]
    si = super_index.long().clamp(0, num_super - 1)
    out = (pos - center[si]) / (diameter[si][:, None] + 1e-2)
    return out, diameter[:, None]


class UnitSphereNorm(nn.Module):
    """`unit_sphere_norm` as a module (no parameters)."""

    def __init__(self, log_diameter=False):
        super().__init__()
        self.log_diameter = log_diameter

    def forward(self, pos, super_index, num_super, node_size=None,
                mask=None):
        """(normalized pos [N, 3], per-segment diameter [num_super, 1],
        log(diameter + 1) with `log_diameter`)."""
        out, d = unit_sphere_norm(pos, super_index, num_super,
                                  node_size=node_size, mask=mask)
        return out, torch.log(d + 1) if self.log_diameter else d


# the norms whose statistics are indexed by graph (their `batch`)
INDEX_BASED_NORMS = (GraphNorm, LayerNorm, InstanceNorm, GroupNorm)
