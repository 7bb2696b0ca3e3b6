"""Graph-partition sharding of one NAG over the ranks of a group: a numpy
copy of `shard_padded_nag` in `superpoint_transformer_tpu/parallel/
shard_nag.py`, over the port's `data/pad.py`.

  1. the top level's nodes are split into `n_dev` contiguous chunks
     (sorted by parent, so spatially coherent);
  2. every lower node goes to its parent's rank, so that pooling,
     unpooling and the per-segment position norms stay on one rank;
  3. horizontal neighbor ids are rewritten to global slots
     (`rank * capacity + local slot`): each attention block gathers the
     ranks' k/v rows into one table (`nn/attention.py`).

The per-graph norm statistics are summed over the ranks inside the norms
(`nn/norm.py`, `shard_group`). Where JAX stacks the shards on a leading
device axis, this returns one padded batch a rank: rank r takes
`shards[r]` (and `data.padded.from_numpy` moves it to its device).
"""
import numpy as np

from ..data.pad import bucket, sort_nag_by_super
from ..data.padded import PaddedLevel, PaddedNAG
from ..ops.graph import edges_to_dense_neighbors

__all__ = ['shard_padded_nag', 'shard_assignment']


def _pad_to(a, n, fill=0):
    if a.shape[0] == n:
        return a
    width = [(0, n - a.shape[0])] + [(0, 0)] * (a.ndim - 1)
    return np.pad(a, width, constant_values=fill)


def shard_assignment(nag, n_dev):
    """{level: (rank [N] int32, local slot [N] int64)} of every node of a
    NAG sorted by parent: the top level in `n_dev` contiguous chunks,
    each lower node on its parent's rank, in NAG order within a rank."""
    top = nag.end_i_level
    n_top = nag[top].num_nodes
    bounds = np.linspace(0, n_top, n_dev + 1).astype(np.int64)
    a = np.zeros(n_top, np.int32)
    for d in range(n_dev):
        a[bounds[d]:bounds[d + 1]] = d
    assign = {top: a}
    for i in range(top - 1, nag.start_i_level - 1, -1):
        assign[i] = assign[i + 1][nag[i].super_index]
    out = {}
    for i in nag.levels:
        a = assign[i]
        order = np.argsort(a, kind='stable')
        starts = np.zeros(n_dev + 1, np.int64)
        np.cumsum(np.bincount(a, minlength=n_dev), out=starts[1:])
        local = np.empty(a.shape[0], np.int64)
        local[order] = np.arange(a.shape[0]) - starts[a[order]]
        out[i] = (a, local)
    return out


def shard_padded_nag(nag, n_dev, num_classes=None):
    """Shard a host NAG (batched, transforms complete, as `pad_nag` takes
    it) over `n_dev` ranks. Returns `n_dev` `PaddedNAG`s of numpy arrays,
    whose levels have one capacity on every rank; neighbor ids are global
    slots, and no transpose neighbor table is built (the sharded
    attention gathers through `gather_rows`)."""
    nag = sort_nag_by_super(nag)
    local_of = shard_assignment(nag, n_dev)
    caps = {i: bucket(int(np.bincount(local_of[i][0], minlength=n_dev)
                          .max())) for i in nag.levels}
    fields = ('pos', 'node_mask', 'batch', 'num_nodes', 'x', 'node_size',
              'super_index', 'y', 'nbr_idx', 'nbr_mask', 'edge_feat')
    shards = [{i: {} for i in nag.levels} for _ in range(n_dev)]
    for i in nag.levels:
        d_level = nag[i]
        n = d_level.num_nodes
        a, local = local_of[i]
        cap = caps[i]
        order = np.argsort(a, kind='stable')
        starts = np.zeros(n_dev + 1, np.int64)
        np.cumsum(np.bincount(a, minlength=n_dev), out=starts[1:])

        # global slot of each node: rank * capacity + local slot
        gslot = a.astype(np.int64) * cap + local
        if i > nag.start_i_level and d_level.get('edge_index') is not None \
                and d_level.num_edges > 0:
            nbr_idx, nbr_mask, edge_id = edges_to_dense_neighbors(
                d_level.edge_index, n)
            nbr_global = np.where(nbr_mask, gslot[nbr_idx], 0)
            ea = d_level.get('edge_attr')
        else:
            nbr_idx = None

        y = d_level.get('y')
        if y is not None:
            y = np.asarray(y)
            if y.ndim == 1 and num_classes is not None:
                h = np.zeros((n, num_classes + 1), np.float32)
                valid = (y >= 0) & (y <= num_classes)
                h[np.arange(n)[valid], y[valid]] = 1.0
                y = h
            y = y.astype(np.float32)

        for d in range(n_dev):
            sel = order[starts[d]:starts[d + 1]]
            nd = sel.shape[0]
            out = shards[d][i]
            out['pos'] = _pad_to(np.asarray(d_level.pos, np.float32)[sel],
                                 cap)
            out['node_mask'] = np.arange(cap) < nd
            b = np.full(cap, -1, np.int32)
            bv = d_level.get('batch')
            b[:nd] = bv[sel] if bv is not None else 0
            out['batch'] = b
            out['num_nodes'] = np.int32(nd)
            if d_level.get('x') is not None:
                out['x'] = _pad_to(np.asarray(d_level.x, np.float32)[sel],
                                   cap)
            if d_level.get('node_size') is not None:
                out['node_size'] = _pad_to(np.asarray(
                    d_level.node_size, np.float32).reshape(-1)[sel], cap)
            if i < nag.end_i_level:
                # a parent lies on its children's rank: its local slot;
                # padded rows point past the parent capacity
                plocal = local_of[i + 1][1]
                si = np.full(cap, caps[i + 1], np.int32)
                si[:nd] = plocal[d_level.super_index[sel]].astype(np.int32)
                out['super_index'] = si
            if y is not None:
                out['y'] = _pad_to(y[sel], cap)
            if nbr_idx is not None:
                out['nbr_idx'] = _pad_to(nbr_global[sel].astype(np.int32),
                                         cap)
                out['nbr_mask'] = _pad_to(nbr_mask[sel], cap)
                if ea is not None:
                    out['edge_feat'] = _pad_to(
                        np.asarray(ea, np.float32)[edge_id[sel]]
                        * nbr_mask[sel][..., None], cap)
    return [PaddedNAG(
        levels=tuple(PaddedLevel(**{k: s[i][k] for k in fields
                                    if k in s[i]}) for i in nag.levels),
        start_i_level=nag.start_i_level, num_graphs=1) for s in shards]
