"""Device preprocessing: voxel grid sampling and grid-hash fixed-radius
KNN as torch ops on the tensors' device. Counterpart of
`superpoint_transformer_tpu/ops/device_preprocess.py` (the reference's
`GridSampling3D`, src/transforms/sampling.py:86, and FRNN
`frnn_grid_points`, src/utils/neighbors.py:24), with the same arithmetic:
int64 cell keys packed 21 bits an axis, a stable sort by key,
`searchsorted` windows over the sorted keys capped at `cell_cap`
candidates a cell, `d2 <= r*r` in f32, self and invalid points excluded,
-1 / +inf padding, results in input order.

The JAX kernel scans a `[chunk, (2*reach+1)^3 * cell_cap]` candidate
tile, most of it empty slots of sparse cells. Here each block of query
rows lists only the candidates its windows hold, in pieces whose dense
`[rows, most candidates of a row]` table is bounded, so memory follows
the cloud's real neighborhoods. The
k nearest come out in JAX's order: `jax.lax.top_k(-d2, k)` puts the
lower candidate column first on equal distances, and the int64 key
`(f32 bits of d2) << 32 | column` sorts the same way (the bits of a
non-negative float are monotone in its value), exactly and
deterministically.
"""
import numpy as np
import torch

from .segment import segment_sum

__all__ = ['voxelize_device', 'grid_knn_device']

# 21 bits per axis -> 63-bit linearized cell key (fits int64)
_AXIS_BITS = 21
_AXIS_SPAN = 1 << _AXIS_BITS
_INT64_MAX = torch.iinfo(torch.int64).max
_INT32_MAX = torch.iinfo(torch.int32).max


# a piece of query rows holds at most this many entries in its dense
# [rows, most candidates of a row] table, and so at most this many
# candidates (~80 bytes each in the temporaries); a single row may
# exceed it
_MAX_CANDIDATES = 1 << 22


def _cell_keys(pos, size, valid):
    """Linearized voxel-cell key per point; invalid points get the
    largest key so they sort to the tail."""
    # a true f32 division by a 1-element tensor on the device: a CPU
    # scalar divisor may become a product by its reciprocal on the card,
    # which rounds differently
    size = torch.tensor([size], dtype=torch.float32, device=pos.device)
    cell = torch.floor(pos / size).to(torch.int64)
    fill = torch.full_like(cell, _INT32_MAX)
    cell = cell - torch.where(valid[:, None], cell, fill).min(0).values
    # zero invalid cells BEFORE packing so the int64 key can't overflow
    # (their key is overwritten below anyway)
    cell = torch.where(valid[:, None], cell, torch.zeros_like(cell))
    key = (cell[:, 0] * _AXIS_SPAN + cell[:, 1]) * _AXIS_SPAN + cell[:, 2]
    return torch.where(valid, key, torch.full_like(key, _INT64_MAX))


def voxelize_device(pos, feats, valid, size, voxel_cap):
    """Voxel grid sampling on the tensors' device (GridSampling3D
    analogue): points of one `floor(pos / size)` cell form a voxel.

    :param pos: [N, 3] float32, padded
    :param feats: [N, F] float32 per-point features to average (F may
        be 0)
    :param valid: [N] bool mask of real points
    :param size: float voxel size
    :param voxel_cap: output capacity (>= number of voxels)
    :return: dict with
        pos_mean    [voxel_cap, 3] per-voxel mean position
        feat_mean   [voxel_cap, F]
        counts      [voxel_cap] int32 (0 on padding)
        num_voxels  [] int32
        super_index [N] int32 voxel id per input point (input order;
                    -1 on padding)
    Voxels are numbered in cell-key order. The sums are
    `ops/segment.py:segment_sum` over the sorted rows: deterministic."""
    n = pos.shape[0]
    key = _cell_keys(pos, size, valid)
    order = torch.argsort(key, stable=True)
    k_sorted = key[order]
    valid_sorted = valid[order]
    first = torch.ones_like(valid_sorted)
    first[1:] = k_sorted[1:] != k_sorted[:-1]
    first = first & valid_sorted
    seg_sorted = torch.cumsum(first, 0, dtype=torch.int32) - 1
    seg_sorted = torch.where(valid_sorted, seg_sorted,
                             torch.full_like(seg_sorted, voxel_cap - 1))
    num_voxels = first.sum().to(torch.int32)

    # per-point voxel id back in input order
    super_index = torch.empty(n, dtype=torch.int32, device=pos.device)
    super_index[order] = torch.where(valid_sorted, seg_sorted,
                                     torch.full_like(seg_sorted, -1))

    w = valid_sorted.to(torch.float32)
    counts = segment_sum(w, seg_sorted, voxel_cap, indices_are_sorted=True)
    denom = torch.clamp(counts, min=1.0)[:, None]
    pos_mean = segment_sum(pos[order] * w[:, None], seg_sorted, voxel_cap,
                           indices_are_sorted=True) / denom
    if feats.shape[1]:
        feat_mean = segment_sum(feats[order] * w[:, None], seg_sorted,
                                voxel_cap, indices_are_sorted=True) / denom
    else:
        feat_mean = feats.new_zeros((voxel_cap, 0))
    return dict(pos_mean=pos_mean, feat_mean=feat_mean,
                counts=counts.to(torch.int32), num_voxels=num_voxels,
                super_index=super_index)


def grid_knn_device(pos, valid, r, k, cell_cap=16, chunk=16384,
                    exclude_self=True, cell_size=None, reach=1):
    """Fixed-radius KNN via a uniform grid (FRNN analogue, reference
    src/utils/neighbors.py:24) on the tensors' device: sort points by
    cell, then for every query scan the (2*reach+1)^3 neighboring cells
    through searchsorted windows capped at `cell_cap` candidates per
    cell, and keep the k nearest within r.

    `cell_size` defaults to r/reach, the smallest size whose
    `reach`-window covers the whole r-ball; with a smaller `cell_size`
    (the SPT regime: k=45 within r_max=2 m of ~3 cm voxels) candidates
    outside the window are not returned.

    Queries run in blocks of `chunk` rows, and each block in pieces of
    rows whose count times the piece's largest row candidate count is at
    most `_MAX_CANDIDATES` (a single row may exceed it); neither changes
    the result.

    Returns (nbr [N, k] int32 with -1 padding, dist [N, k] float32 with
    +inf padding), in input order. A cell denser than `cell_cap`
    truncates its candidates to the first `cell_cap` in key order."""
    n = pos.shape[0]
    dev = pos.device
    if cell_size is None:
        cell_size = r / reach
    key = _cell_keys(pos, cell_size, valid)
    order = torch.argsort(key, stable=True)
    k_sorted = key[order]
    pos_sorted = pos[order]
    valid_sorted = valid[order]
    # invalid queries return nothing: a zero key keeps their windows'
    # arithmetic in range
    q_key = torch.where(valid, key, torch.zeros_like(key))

    # (2*reach+1)^3 neighbor-cell key offsets
    rng_off = range(-reach, reach + 1)
    offs = torch.tensor([(dx * _AXIS_SPAN + dy) * _AXIS_SPAN + dz
                         for dx in rng_off for dy in rng_off
                         for dz in rng_off], dtype=torch.int64, device=dev)
    r2 = torch.tensor(r * r, dtype=torch.float32, device=dev)

    nbr = torch.full((n, k), -1, dtype=torch.int32, device=dev)
    dist = torch.full((n, k), float('inf'), dtype=torch.float32,
                      device=dev)
    for s in range(0, n, chunk):
        e = min(s + chunk, n)
        nk = q_key[s:e, None] + offs[None, :]                  # [C, W]
        start = torch.searchsorted(k_sorted, nk)
        end = torch.searchsorted(k_sorted, nk, right=True)
        cnt = torch.clamp(end - start, max=cell_cap) \
            * valid[s:e, None].to(torch.int64)
        row_cnt = cnt.sum(1).cpu().numpy()
        a = 0
        while a < e - s:
            b = a + _piece_rows(row_cnt[a:], k)
            _knn_piece(s + a, start[a:b], cnt[a:b], int(row_cnt[a:b].sum()),
                       pos, pos_sorted, valid_sorted, order, r2, k,
                       cell_cap, exclude_self, nbr, dist)
            a = b
    return nbr, dist


def _piece_rows(row_cnt, k):
    """How many of the leading rows (candidate counts `row_cnt`) one
    piece takes: the most whose dense table, rows x max(their largest
    count, k), holds at most `_MAX_CANDIDATES` entries; at least one."""
    width = np.maximum(np.maximum.accumulate(row_cnt), k)
    size = width * np.arange(1, len(row_cnt) + 1)
    return max(int(np.searchsorted(size, _MAX_CANDIDATES, side='right')),
               1)


def _knn_piece(q0, start, cnt, total, pos, pos_sorted, valid_sorted, order,
               r2, k, cell_cap, exclude_self, nbr, dist):
    """The k nearest of the queries q0 .. q0+R-1, whose windows
    [start, start+cnt) over the sorted points ([R, W] each) hold `total`
    candidates; written into rows q0.. of `nbr` and `dist`."""
    dev = pos.device
    rows, width = cnt.shape
    if total == 0:
        return
    cnt = cnt.reshape(-1)
    # one entry per candidate: its (row, cell) window and its position
    # in the window
    rc = torch.repeat_interleave(torch.arange(rows * width, device=dev),
                                 cnt, output_size=total)
    excl = torch.cumsum(cnt, 0) - cnt
    j = torch.arange(total, device=dev) - excl[rc]
    cand = start.reshape(-1)[rc] + j
    qr = torch.div(rc, width, rounding_mode='floor')
    col = (rc - qr * width) * cell_cap + j   # column of JAX's [W * cap]
    q = qr + q0
    d = pos_sorted[cand] - pos[q]
    d2 = d[:, 0] * d[:, 0] + d[:, 1] * d[:, 1] + d[:, 2] * d[:, 2]
    sid = order[cand]                        # input order
    ok = valid_sorted[cand] & (d2 <= r2)
    if exclude_self:
        ok = ok & (sid != q)
    qr, col, d2, sid = qr[ok], col[ok], d2[ok], sid[ok]
    m = qr.shape[0]
    # a dense [R, max hits] table of (d2 bits, column) keys per row
    # (qr is non-decreasing: the candidates come row by row)
    per = torch.bincount(qr, minlength=rows)
    tab_w = max(int(per.max()), k)
    rank = torch.arange(m, device=dev) - (torch.cumsum(per, 0) - per)[qr]
    keys = (d2.view(torch.int32).to(torch.int64) << 32) | col
    tab = torch.full((rows, tab_w), _INT64_MAX, dtype=torch.int64,
                     device=dev)
    tab[qr, rank] = keys
    at = torch.full((rows, tab_w), m, dtype=torch.int64, device=dev)
    at[qr, rank] = torch.arange(m, device=dev)
    _, ti = torch.topk(tab, k, dim=1, largest=False, sorted=True)
    pick = at.gather(1, ti)                  # m where no candidate
    sid = torch.cat([sid.to(torch.int32),
                     torch.full((1,), -1, dtype=torch.int32, device=dev)])
    d2 = torch.cat([d2, torch.full((1,), float('inf'), device=dev)])
    nbr[q0:q0 + rows] = sid[pick]
    dist[q0:q0 + rows] = torch.sqrt(d2[pick])
