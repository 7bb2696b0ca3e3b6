"""Segment (scatter) operations over padded index vectors.

Counterpart of `superpoint_transformer_tpu/ops/segment.py`. The padded
layout marks rows that belong to no segment with an index of -1 (the
`batch` of padded nodes) or `num_segments` (the `super_index` of padded
children). JAX's segment ops drop such rows; PyTorch's `index_add_`,
`scatter_reduce_` and `t[idx]` would wrap -1 onto the last row or raise.
Every op here therefore routes out-of-range rows to one spare dump row
that is sliced off before returning.

Float segment sums are deterministic on every device: no float atomics
(`index_add_` on CUDA adds in a varying order, which the random-weight
model amplified into logits that differed from run to run by ~1e-2). As
in the JAX package, at most `_ONEHOT_MAX_SEGMENTS` segments over at
least 1024 rows are a one-hot contraction in f32 (GraphNorm's per-graph
statistics); other float sums are a sorted segmented reduction
(`torch.segment_reduce`) over the rows, sorted first unless the caller
says they are. The gathers' backward is such a sum too (`gather_rows`).
"""
import math

import torch
import torch.nn.functional as F

from ..utils.flops import count_contraction
from ..utils.profiling import annotate

__all__ = ['segment_sum', 'segment_count', 'segment_max', 'segment_min',
           'segment_mean', 'segment_std', 'segment_softmax',
           'segment_mean_weighted', 'segment_csr_arange', 'gather_rows',
           'gather_rows_small']

# the JAX package's threshold for the one-hot form
_ONEHOT_MAX_SEGMENTS = 128


def _dump_index(idx, num_segments):
    """`idx` with every out-of-range entry replaced by `num_segments`,
    the index of the spare dump row."""
    idx = idx.long()
    bad = (idx < 0) | (idx >= num_segments)
    return torch.where(bad, torch.full_like(idx, num_segments), idx)


class _OneHotSegmentSum(torch.autograd.Function):
    """Sum of the f32 rows `x` [N, C] per segment as the contraction
    one_hot(idx)^T @ x, in exact f32 passes whatever the matmul precision
    setting (TF32 would round the summands). Its backward, one_hot @ g,
    picks one row of g for each row of x: a gather, exact (in a
    `spt.gather` span, as the other gathers)."""

    @staticmethod
    def forward(ctx, x, idx, num_segments):
        ctx.save_for_backward(idx)
        ctx.num_segments = num_segments
        oh = (idx[:, None] == torch.arange(
            num_segments, device=idx.device)[None, :]).to(x.dtype)
        prev = torch.get_float32_matmul_precision()
        torch.set_float32_matmul_precision('highest')
        try:
            return oh.t() @ x
        finally:
            torch.set_float32_matmul_precision(prev)

    @staticmethod
    def backward(ctx, g):
        idx, = ctx.saved_tensors
        with annotate('spt.gather'):
            zero = g.new_zeros((1, g.shape[1]))
            rows = _dump_index(idx, ctx.num_segments)
            return F.embedding(rows, torch.cat([g, zero])), None, None


# rows one thread sums in the first pass of a sorted segment sum
_PIECE = 256


def _sorted_segment_sum(x, idx, num_segments):
    """Per-segment sum of the rows `x` [N, ...], whose `idx` is sorted
    (out-of-range rows form a run below 0 and one at or above
    `num_segments`, never read: they may be most of a padded level).
    Two passes of `torch.segment_reduce`, each in a fixed order: pieces of
    a segment cut at every `_PIECE`-th row, then each segment's pieces.
    One pass would sum a segment in one thread, and a segment can hold
    ~1M rows (a gather's backward, where every padded slot points at one
    row)."""
    dev = x.device
    i = idx.long().clamp(-1, num_segments)
    bounds = torch.searchsorted(i, torch.arange(num_segments + 1,
                                                device=dev))
    cuts = torch.arange(1, (x.shape[0] - 1) // _PIECE + 1,
                        device=dev) * _PIECE
    cuts = torch.minimum(torch.maximum(cuts, bounds[0]), bounds[-1])
    offsets = torch.sort(torch.cat([bounds, cuts])).values
    pieces = torch.segment_reduce(x, 'sum', offsets=offsets, axis=0,
                                  unsafe=True)
    # the segment of each piece (a piece of no rows may go to any)
    seg = torch.searchsorted(bounds, offsets[:-1], right=True) - 1
    starts = torch.searchsorted(seg, torch.arange(num_segments + 1,
                                                  device=dev))
    return torch.segment_reduce(pieces, 'sum', offsets=starts, axis=0,
                                unsafe=True)


def segment_sum(x, idx, num_segments, indices_are_sorted=False,
                acc_dtype=None):
    """Sum of the rows of `x` [N, ...] per segment -> [num_segments, ...].

    `acc_dtype` (e.g. float32 under bf16 activations) is the
    accumulation and output dtype. Float sums are deterministic (see the
    module docstring); `indices_are_sorted` says that `idx` is
    non-decreasing, which spares the sort of the general case. Integer
    sums are exact in any order and use `index_add_`."""
    dt = acc_dtype or x.dtype
    if not (dt.is_floating_point or x.dtype.is_floating_point):
        out = torch.zeros((num_segments + 1,) + tuple(x.shape[1:]),
                          dtype=dt, device=x.device)
        out.index_add_(0, _dump_index(idx, num_segments), x.to(dt))
        return out[:num_segments]
    n = x.shape[0]
    if num_segments <= _ONEHOT_MAX_SEGMENTS and n >= 1024:
        flat = x.reshape(n, -1).to(torch.float32)
        out = _OneHotSegmentSum.apply(flat, idx.long(), num_segments)
        return out.reshape((num_segments,) + tuple(x.shape[1:])).to(dt)
    x = x.to(dt)
    if not indices_are_sorted:
        order = torch.argsort(idx.long().clamp(-1, num_segments),
                              stable=True)
        idx = idx[order]
        x = gather_rows(x.reshape(n, -1), order).reshape(x.shape)
    return _sorted_segment_sum(x, idx, num_segments)


def segment_count(idx, num_segments, mask=None):
    """Number of rows per segment (int64); `mask` marks valid rows. As
    in the JAX package, at most `_ONEHOT_MAX_SEGMENTS` segments over
    1024 to 2^24 rows are counted by the one-hot contraction of f32 ones
    (exact below 2^24; int64 atomics onto a few rows serialize on
    CUDA)."""
    n = idx.shape[0]
    if num_segments <= _ONEHOT_MAX_SEGMENTS and 1024 <= n < 2 ** 24:
        ones = torch.ones(n, dtype=torch.float32, device=idx.device)
        if mask is not None:
            ones = ones * mask.to(torch.float32)
        return segment_sum(ones, idx, num_segments).to(torch.int64)
    ones = torch.ones(n, dtype=torch.int64, device=idx.device)
    if mask is not None:
        ones = ones * mask.long()
    return segment_sum(ones, idx, num_segments)


def _segment_extreme(x, idx, num_segments, reduce, identity):
    out = torch.full((num_segments + 1,) + tuple(x.shape[1:]), identity,
                     dtype=x.dtype, device=x.device)
    index = _dump_index(idx, num_segments).view(
        (-1,) + (1,) * (x.dim() - 1)).expand_as(x)
    out.scatter_reduce_(0, index, x, reduce=reduce, include_self=True)
    return out[:num_segments]


def segment_max(x, idx, num_segments):
    """Per-segment max of the rows of `x` [N, C]; empty segments give
    -inf (the identity of max, as in `jax.ops.segment_max`)."""
    return _segment_extreme(x, idx, num_segments, 'amax', float('-inf'))


def segment_min(x, idx, num_segments):
    """Per-segment min of the rows of `x` [N, C]; empty segments give
    +inf (the identity of min, as in `jax.ops.segment_min`)."""
    return _segment_extreme(x, idx, num_segments, 'amin', float('inf'))


def _expand(v, like):
    """A per-row vector broadcast against `like`'s trailing dims."""
    return v.reshape(tuple(v.shape) + (1,) * (like.dim() - v.dim()))


def _row_index(idx, num_rows):
    """The row each index reads in a JAX gather `table[idx]`: a negative
    index counts from the end, and the result is clamped into range."""
    idx = idx.long()
    idx = torch.where(idx < 0, idx + num_rows, idx)
    return idx.clamp(0, num_rows - 1)


def _gather(table, idx, num_rows):
    """`table[idx]` as JAX computes it and its gradient: the row of
    `_row_index`, and no gradient from an index out of range (its
    clamped read is a constant: XLA's scatter drops it), with
    `gather_rows`' reproducible backward."""
    flat = table.reshape(num_rows, -1)
    out = gather_rows(flat, _row_index(idx, num_rows))
    oob = ((idx < -num_rows) | (idx >= num_rows)).reshape(-1, 1)
    out = torch.where(oob, out.detach(), out)
    return out.reshape(tuple(idx.shape) + tuple(table.shape[1:]))


def segment_mean(x, idx, num_segments, indices_are_sorted=False,
                 mask=None):
    """Per-segment mean of the rows of `x`; `mask` marks valid rows;
    an empty segment gives 0."""
    if mask is not None:
        x = x * _expand(mask, x).to(x.dtype)
    s = segment_sum(x, idx, num_segments, indices_are_sorted)
    n = segment_count(idx, num_segments, mask=mask)
    return s / _expand(n.clamp(min=1).to(x.dtype), s)


def segment_std(x, idx, num_segments, indices_are_sorted=False, mask=None,
                correction=1):
    """Per-segment standard deviation, Bessel-corrected by default (the
    JAX `segment_std`, torch_scatter's `scatter_std`): the sum of squared
    deviations from the segment mean over max(n - correction, 1)."""
    if mask is not None:
        x = x * _expand(mask, x).to(x.dtype)
    n = segment_count(idx, num_segments, mask=mask).to(x.dtype)
    s = segment_sum(x, idx, num_segments, indices_are_sorted)
    mean = s / _expand(n.clamp(min=1), s)
    d = x - _gather(mean, idx, num_segments)
    if mask is not None:
        d = d * _expand(mask, d).to(d.dtype)
    var = segment_sum(d * d, idx, num_segments, indices_are_sorted)
    var = var / _expand((n - correction).clamp(min=1), var)
    return torch.sqrt(var.clamp(min=0))


def segment_softmax(x, idx, num_segments, indices_are_sorted=False,
                    mask=None):
    """Softmax of the rows of `x` [N, ...] over the rows sharing a
    segment id; `mask` marks valid rows, which alone take weight. The
    segment max is held constant (it cancels in the value and the
    gradient)."""
    if mask is not None:
        x = torch.where(_expand(mask, x), x,
                        torch.full_like(x, float('-inf')))
    with torch.no_grad():
        m = segment_max(x, idx, num_segments)
        m = torch.where(torch.isfinite(m), m, torch.zeros_like(m))
    e = torch.exp(x - _gather(m, idx, num_segments))
    if mask is not None:
        e = e * _expand(mask, e).to(e.dtype)
    z = segment_sum(e, idx, num_segments, indices_are_sorted)
    z = z.clamp(min=torch.finfo(e.dtype).tiny)
    return e / _gather(z, idx, num_segments)


def segment_mean_weighted(x, idx, w, num_segments,
                          indices_are_sorted=False):
    """Per-segment mean of the rows of `x` [N, C] weighted by `w` [N]; a
    segment of zero total weight divides by 1."""
    w = w.to(x.dtype).reshape(-1)
    s = segment_sum(x * w[:, None], idx, num_segments, indices_are_sorted)
    z = segment_sum(w, idx, num_segments, indices_are_sorted)
    z = torch.where(z == 0, torch.ones_like(z), z)
    return s / z[:, None]


def segment_csr_arange(pointers, total):
    """For CSR `pointers` [S + 1] over `total` elements: (the rank of each
    element within its segment, [0..n0-1, 0..n1-1, ...], and its segment
    id), both [total] int64. Elements past the last pointer count in the
    last segment."""
    n = pointers.shape[0] - 1
    seg_id = torch.searchsorted(
        pointers, torch.arange(total, dtype=pointers.dtype,
                               device=pointers.device), right=True) - 1
    seg_id = seg_id.clamp(0, n - 1)
    rank = torch.arange(total, device=pointers.device) - pointers[seg_id]
    return rank.long(), seg_id


class _GatherRows(torch.autograd.Function):
    """`table[idx]` as an embedding lookup, whose backward sums each
    row's cotangents with `segment_sum` (a one-hot contraction or a
    sorted reduction, in f32 for a bf16 table) rather than the embedding
    backward, which is not reproducible on CUDA (for a few thousand
    indices, or fewer, it adds in a varying order)."""

    @staticmethod
    def forward(ctx, table, idx):
        ctx.save_for_backward(idx)
        ctx.num_rows = table.shape[0]
        return F.embedding(idx, table)

    @staticmethod
    def backward(ctx, g):
        idx, = ctx.saved_tensors
        acc = torch.float32 if g.dtype in (torch.bfloat16, torch.float16) \
            else g.dtype
        with annotate('spt.gather'):
            d = segment_sum(g.reshape(-1, g.shape[-1]), idx.reshape(-1),
                            ctx.num_rows, acc_dtype=acc)
            return d.to(g.dtype), None


def gather_rows(table, idx):
    """`table[idx]` for a 2-D `table` and in-range indices of any shape,
    as an embedding lookup, with a reproducible backward (`_GatherRows`).
    The two give the same values and gradients; on CUDA the backward of
    advanced indexing accumulates with `index_put_`, which walks each run
    of equal indices in one thread: a row gathered many times (a neighbor
    slot of ~48 nodes) made it take 97% of the flagship training step on
    an H100. Forward and backward run in `spt.gather` spans."""
    with annotate('spt.gather'):
        return _GatherRows.apply(table, idx)


def gather_rows_small(table, idx, num_rows):
    """`table[idx]` for a small per-segment table [G, C]; an
    out-of-range index (-1 on padded rows) gives a zero row, as the
    JAX one-hot form does. For a float table of at most
    `_ONEHOT_MAX_SEGMENTS` rows the FLOP count (`utils/flops.py`) adds
    that form's contraction, 2 * N * G * C, as the JAX count does; its
    backward here is a `segment_sum`, counted where it contracts."""
    with annotate('spt.gather'):
        zero = torch.zeros((1,) + tuple(table.shape[1:]), dtype=table.dtype,
                           device=table.device)
        out = gather_rows(torch.cat([table[:num_rows], zero]),
                          _dump_index(idx, num_rows))
    if num_rows <= _ONEHOT_MAX_SEGMENTS and table.dtype.is_floating_point:
        out = count_contraction(
            out, 2 * idx.shape[0] * num_rows * math.prod(table.shape[1:]),
            backward_flops=0)
    return out
