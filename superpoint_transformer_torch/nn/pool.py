"""Child -> parent pooling: the segment pools and the attentive pools.

Counterpart of `superpoint_transformer_tpu/nn/pool.py`. Padded children
carry `index == num_parents` and are dropped; `mask` marks the valid
children. `AttentivePool` is a softmax over each parent's children
(`ops/segment.py:segment_softmax`, deterministic on every device), with
queries from the parents (or one learnt query) and keys and values from
the children, and optional k/q relative position encodings of the
vertical edge features.
"""
import torch
from torch import nn

from ..ops.segment import (gather_rows, segment_max,
                           segment_mean, segment_min, segment_softmax,
                           segment_std, segment_sum)
from ..utils.flops import count_contraction
from .attention import qk_scale_from_degree

__all__ = ['pool', 'AttentivePool', 'AttentivePoolWithLearntQueries',
           'POOL_MODES']

POOL_MODES = ('max', 'min', 'mean', 'sum', 'std')


def pool(mode, x_child, index, num_parents, mask=None):
    """Pool children into parents by `mode` ('max', 'min', 'mean', 'sum'
    or 'std'). For max and min, masked children take the -/+finfo.max
    sentinel and a parent with no valid child comes out as 0."""
    big = torch.finfo(x_child.dtype).max
    if mode == 'max':
        xc = x_child if mask is None else torch.where(
            mask[:, None], x_child, torch.full_like(x_child, -big))
        out = segment_max(xc, index, num_parents)
        return torch.where(out <= -big * 0.5, torch.zeros_like(out), out)
    if mode == 'min':
        xc = x_child if mask is None else torch.where(
            mask[:, None], x_child, torch.full_like(x_child, big))
        out = segment_min(xc, index, num_parents)
        return torch.where(out >= big * 0.5, torch.zeros_like(out), out)
    if mode == 'mean':
        return segment_mean(x_child, index, num_parents,
                            indices_are_sorted=True, mask=mask)
    if mode == 'sum':
        xc = x_child if mask is None else \
            x_child * mask[:, None].to(x_child.dtype)
        return segment_sum(xc, index, num_parents, indices_are_sorted=True)
    if mode == 'std':
        return segment_std(x_child, index, num_parents,
                           indices_are_sorted=True, mask=mask)
    raise ValueError(f'unknown pool mode {mode!r}')


class AttentivePool(nn.Module):
    """Attentive pooling of children into parents: H heads of qk_dim D;
    the query of a child's parent (a Linear of the parent features
    `x_parent`, or with `learnt_queries` one learnt vector `q`), the
    child's key and value (one Linear `kv` of the child features), the
    degree-aware scale of `qk_scale` on the parent's valid child count,
    and a softmax over each parent's children. `k_rpe` / `q_rpe` add
    Linear encodings of the vertical edge features `edge_attr`
    [Nc, in_rpe_dim] to the keys / queries (shared by the heads with
    `heads_share_rpe`). Output [num_parents, dim] f32.

    `in_dim` and `parent_dim` are the widths of the child and parent
    features (flax reads them at the first call)."""

    def __init__(self, dim, in_dim, parent_dim=None, num_heads=1,
                 qkv_bias=True, qk_dim=8, qk_scale=None, in_rpe_dim=9,
                 k_rpe=False, q_rpe=False, heads_share_rpe=False,
                 learnt_queries=False, device=None):
        super().__init__()
        H, D, C = num_heads, qk_dim, dim
        self.num_heads, self.qk_dim, self.dim = H, D, C
        self.qk_scale = qk_scale
        self.heads_share_rpe = heads_share_rpe
        self.learnt_queries = learnt_queries
        self.kv = nn.Linear(in_dim, H * D + C, bias=qkv_bias, device=device)
        if learnt_queries:
            # flax truncated_normal(0.02): +-2 standard deviations
            self.q = nn.Parameter(nn.init.trunc_normal_(
                torch.empty(H * D, device=device), std=0.02, a=-0.04,
                b=0.04))
        else:
            if parent_dim is None:
                raise ValueError('AttentivePool: parent_dim is needed for '
                                 'queries from the parent features')
            self.q = nn.Linear(parent_dim, H * D, bias=qkv_bias,
                               device=device)
        rpe_dim = D if heads_share_rpe else H * D
        if k_rpe:
            self.k_rpe = nn.Linear(in_rpe_dim, rpe_dim, device=device)
        if q_rpe:
            self.q_rpe = nn.Linear(in_rpe_dim, rpe_dim, device=device)

    def _rpe(self, name, edge_attr, Nc):
        r = getattr(self, name)(edge_attr)
        if self.heads_share_rpe:
            r = r.repeat(1, self.num_heads)
        return r.reshape(Nc, self.num_heads, self.qk_dim)

    def forward(self, x_child, x_parent, index, num_parents, edge_attr=None,
                mask=None):
        Nc = x_child.shape[0]
        H, D, C = self.num_heads, self.qk_dim, self.dim
        DH = H * D
        kv = self.kv(x_child)
        parent = index.long().clamp(0, num_parents - 1)
        if self.learnt_queries:
            q = self.q[None].expand(Nc, DH).reshape(Nc, H, D)
        else:
            q = gather_rows(self.q(x_parent), parent).reshape(Nc, H, D)
        k = kv[:, :DH].reshape(Nc, H, D)
        v = kv[:, DH:].reshape(Nc, H, C // H)
        if hasattr(self, 'k_rpe') and edge_attr is not None:
            k = k + self._rpe('k_rpe', edge_attr, Nc)
        if hasattr(self, 'q_rpe') and edge_attr is not None:
            q = q + self._rpe('q_rpe', edge_attr, Nc)

        # an integer sum, as in JAX (no one-hot contraction)
        ones = torch.ones(Nc, dtype=torch.int64, device=x_child.device)
        if mask is not None:
            ones = ones * mask.long()
        degree = segment_sum(ones, index, num_parents)
        scale = qk_scale_from_degree(self.qk_scale, D, degree[parent])
        q = q * scale[:, None, None]
        # the JAX einsum 'nhd,nhd->nh': a contraction over D
        compat = count_contraction((q * k).sum(-1), 2 * Nc * H * D)
        attn = segment_softmax(compat, index, num_parents,
                               indices_are_sorted=True, mask=mask)
        out = (v * attn[..., None]).reshape(Nc, C)
        if mask is not None:
            out = out * mask[:, None].to(out.dtype)
        return segment_sum(out, index, num_parents, indices_are_sorted=True)


def AttentivePoolWithLearntQueries(**kwargs):
    """An `AttentivePool` whose query is one learnt vector."""
    return AttentivePool(learnt_queries=True, **kwargs)
