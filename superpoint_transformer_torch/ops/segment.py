"""Segment (scatter) operations over padded index vectors.

Counterpart of `superpoint_transformer_tpu/ops/segment.py`. The padded
layout marks rows that belong to no segment with an index of -1 (the
`batch` of padded nodes) or `num_segments` (the `super_index` of padded
children). JAX's segment ops drop such rows; PyTorch's `index_add_`,
`scatter_reduce_` and `t[idx]` would wrap -1 onto the last row or raise.
Every op here therefore routes out-of-range rows to one spare dump row
that is sliced off before returning.
"""
import torch

__all__ = ['segment_sum', 'segment_count', 'segment_max',
           'gather_rows_small']


def _dump_index(idx, num_segments):
    """`idx` with every out-of-range entry replaced by `num_segments`,
    the index of the spare dump row."""
    idx = idx.long()
    bad = (idx < 0) | (idx >= num_segments)
    return torch.where(bad, torch.full_like(idx, num_segments), idx)


def segment_sum(x, idx, num_segments, acc_dtype=None):
    """Sum of the rows of `x` [N, ...] per segment -> [num_segments, ...].

    `acc_dtype` (e.g. float32 under bf16 activations) is the
    accumulation and output dtype."""
    dt = acc_dtype or x.dtype
    out = torch.zeros((num_segments + 1,) + tuple(x.shape[1:]),
                      dtype=dt, device=x.device)
    out.index_add_(0, _dump_index(idx, num_segments), x.to(dt))
    return out[:num_segments]


def segment_count(idx, num_segments, mask=None):
    """Number of rows per segment (int64); `mask` marks valid rows."""
    ones = torch.ones(idx.shape[0], dtype=torch.int64, device=idx.device)
    if mask is not None:
        ones = ones * mask.long()
    return segment_sum(ones, idx, num_segments)


def segment_max(x, idx, num_segments):
    """Per-segment max of the rows of `x` [N, C]; empty segments give
    -inf (the identity of max, as in `jax.ops.segment_max`)."""
    out = torch.full((num_segments + 1,) + tuple(x.shape[1:]),
                     float('-inf'), dtype=x.dtype, device=x.device)
    index = _dump_index(idx, num_segments).view(
        (-1,) + (1,) * (x.dim() - 1)).expand_as(x)
    out.scatter_reduce_(0, index, x, reduce='amax', include_self=True)
    return out[:num_segments]


def gather_rows_small(table, idx, num_rows):
    """`table[idx]` for a small per-segment table [G, C]; an
    out-of-range index (-1 on padded rows) gives a zero row, as the
    JAX one-hot form does."""
    zero = torch.zeros((1,) + tuple(table.shape[1:]), dtype=table.dtype,
                       device=table.device)
    return torch.cat([table[:num_rows], zero])[_dump_index(idx, num_rows)]
