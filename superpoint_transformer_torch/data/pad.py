"""From NAGs to one padded batch on the host: a copy of `bucket`,
`batch_nags`, `sort_nag_by_super`, `pad_nag` and `pad_point_cloud` of
the JAX package's `data/pad.py`.

Ragged `NAG` hierarchies (numpy) become one `PaddedNAG` of
fixed-capacity numpy arrays and masks, with the JAX field names;
`data.padded.from_numpy` then moves it to a torch device. Capacities are
bucketed, so that batches of similar size share shapes.

  - the horizontal graph becomes a dense `[N, K]` neighbor layout
    (exact: K >= max degree, no edge dropped);
  - levels are sorted by `super_index`, so that pooling and
    unit-sphere norms run as sorted segment ops;
  - padded child nodes carry `super_index == parent capacity`.
"""
import numpy as np

from .csr import Cluster
from .data import Data
from .nag import NAG
from .padded import PaddedLevel, PaddedNAG, PaddedPointCloud
from ..ops.graph import edges_to_dense_neighbors, _round_up
from ..ops.voxel_conv import build_sparse_conv_neighbors

__all__ = ['batch_nags', 'sort_nag_by_super', 'pad_nag', 'bucket',
           'pad_point_cloud', 'transpose_neighbors']


def bucket(n, mode='pow2_fine', minimum=128):
    """Round a count up to a bucketed static capacity.

    'pow2_fine' (default) splits every power-of-two octave into 8
    steps (quantum 2^(k-3), at least 128): worst-case padding waste is
    1.125x where 'pow2' wastes up to 2x, with 8 buckets per octave.
    'exact' keeps the count (at least `minimum`)."""
    n = max(int(n), minimum)
    if mode == 'pow2':
        return 1 << (n - 1).bit_length()
    if mode == 'pow2_fine':
        k = (n - 1).bit_length()
        q = max(1 << max(k - 3, 0), 128)
        return -(-n // q) * q
    if mode == 'exact':
        return n
    raise ValueError(mode)


def batch_nags(nag_list):
    """Collate a list of NAGs into one NAG with per-level index offsets
    and a `batch` graph-id vector."""
    if len(nag_list) == 1:
        nag = nag_list[0]
        for i in nag.levels:
            d = nag[i]
            d['batch'] = np.zeros(d.num_nodes, dtype=np.int64)
        return nag
    start = nag_list[0].start_i_level
    n_levels = nag_list[0].num_levels
    out_levels = []
    for li in range(n_levels):
        i = start + li
        datas = [nag[i] for nag in nag_list]
        out_levels.append(_collate_level(datas, i, nag_list, start))
    return NAG(out_levels, start_i_level=start)


def _collate_level(datas, i, nag_list, start):
    out = Data()
    node_offsets = np.cumsum([0] + [d.num_nodes for d in datas])
    # parent offsets for super_index
    if i < nag_list[0].end_i_level:
        parent_offsets = np.cumsum(
            [0] + [nag[i + 1].num_nodes for nag in nag_list])
    # child offsets for sub: one level down inside the NAG, or — at
    # the bottom level, where `sub` holds FULL-RESOLUTION raw point
    # ids — per-item max()+1
    if i > start:
        child_offsets = np.cumsum(
            [0] + [nag[i - 1].num_nodes for nag in nag_list])
    else:
        child_offsets = None

    keys = set()
    for d in datas:
        keys.update(d.keys())
    for k in keys:
        vals = [d.get(k) for d in datas]
        if any(v is None for v in vals):
            continue
        if k == 'super_index':
            out[k] = np.concatenate([
                v.astype(np.int64) + parent_offsets[j]
                for j, v in enumerate(vals)])
        elif k in ('edge_index', 'obj_edge_index'):
            out[k] = np.concatenate([
                v.astype(np.int64) + node_offsets[j]
                for j, v in enumerate(vals)], axis=1)
        elif k == 'sub':
            ptr_off = np.cumsum([0] + [v.num_items for v in vals])
            pointers = np.concatenate(
                [vals[0].pointers.astype(np.int64)] + [
                    v.pointers[1:].astype(np.int64) + ptr_off[j + 1]
                    for j, v in enumerate(vals[1:])])
            offs = child_offsets
            if offs is None:
                sizes = [int(v.points.max()) + 1 if v.points.size
                         else 0 for v in vals]
                offs = np.cumsum([0] + sizes)
            points = np.concatenate([
                v.points.astype(np.int64) + offs[j]
                for j, v in enumerate(vals)])
            out._store['sub'] = Cluster(pointers, points)
        elif isinstance(vals[0], np.ndarray):
            out[k] = np.concatenate([np.asarray(v) for v in vals], axis=0)
    out['batch'] = np.concatenate([
        np.full(d.num_nodes, j, dtype=np.int64)
        for j, d in enumerate(datas)])
    return out


def sort_nag_by_super(nag):
    """Reorder each level's nodes so `super_index` is nondecreasing
    (stable, preserves batch contiguity). Top-down so parent ids are
    final before children sort against them.

    Every per-node array (including a caller-stamped `node_id`) rides
    through `Data.select`; `obj_edge_index`, which select copies
    verbatim, is remapped here."""
    for i in range(nag.end_i_level - 1, nag.start_i_level - 1, -1):
        d = nag[i]
        if 'super_index' not in d:
            continue
        perm = np.argsort(d.super_index, kind='stable')
        if not np.array_equal(perm, np.arange(perm.shape[0])):
            inv = np.empty_like(perm)
            inv[perm] = np.arange(perm.shape[0])
            new_d, _ = d.select(perm)
            if 'obj_edge_index' in new_d:
                new_d._store['obj_edge_index'] = \
                    inv[new_d.obj_edge_index]
            nag[i] = new_d
            d = new_d
            # children point at level-i nodes: remap their super_index
            if i > nag.start_i_level and 'super_index' in nag[i - 1]:
                nag[i - 1]._store['super_index'] = \
                    inv[nag[i - 1].super_index]
        # rebuild parent's sub: children now contiguous per parent
        parent = nag[i + 1]
        counts = np.bincount(d.super_index, minlength=parent.num_nodes)
        pointers = np.zeros(parent.num_nodes + 1, dtype=np.int64)
        np.cumsum(counts, out=pointers[1:])
        parent._store['sub'] = Cluster(
            pointers, np.arange(d.num_nodes, dtype=np.int64))
    return nag


def transpose_neighbors(nbr_idx, nbr_mask, k_in_cap=0):
    """The transpose of a padded neighbor table [cap, K]: for each node m,
    the flattened [cap*K] slots (n, k) with nbr_idx[n, k] == m, in slot
    order, as (in_idx, in_mask) [cap, K_in]; K_in is the largest
    in-degree rounded up to 16 (at least 16 and `k_in_cap`), padded
    slots point at slot 0 with the mask False."""
    cap = nbr_idx.shape[0]
    tgt = nbr_idx[nbr_mask]
    slots = np.flatnonzero(nbr_mask.reshape(-1)).astype(np.int64)
    order = np.argsort(tgt, kind='stable')
    tgt_s, slots_s = tgt[order], slots[order]
    deg_in = np.bincount(tgt_s, minlength=cap)
    k_in = int(max(_round_up(int(deg_in.max(initial=0)), 16), 16,
                   k_in_cap))
    in_idx = np.zeros((cap, k_in), dtype=np.int32)
    in_mask = np.zeros((cap, k_in), dtype=bool)
    starts = np.zeros(cap + 1, dtype=np.int64)
    np.cumsum(deg_in, out=starts[1:])
    rank = np.arange(slots_s.shape[0]) - starts[tgt_s]
    in_idx[tgt_s, rank] = slots_s
    in_mask[tgt_s, rank] = True
    return in_idx, in_mask


def pad_nag(nag, num_classes=None, node_caps=None, k_caps=None,
            k_in_caps=None, bucket_mode='pow2', with_edges_from=1,
            with_transpose=True):
    """Convert a (batched, transform-complete) NAG into a `PaddedNAG`
    of static-capacity numpy arrays, sorted by parent, with the field
    names of the JAX `PaddedLevel`.

    :param num_classes: for converting int labels to histograms
    :param node_caps: dict level->capacity override (else bucketed)
    :param k_caps: dict level->K override for dense neighbors
    :param k_in_caps: dict level->K_in override for the transpose
        neighbor table (max in-degree rounded to 16 otherwise)
    :param with_edges_from: lowest level whose horizontal graph is
        converted to dense neighbors (level 0 has no attention)
    :param with_transpose: build the transpose neighbor tables
        (nbr_in_idx/nbr_in_mask) that the JAX training backward reads
    """
    # Stamp pre-sort row ids on level 1 so batch-order outputs (level-1
    # logits and predictions) map back to the NAG's node order after
    # the sort below
    if 1 in nag.levels and 'node_id' not in nag[1]:
        nag[1]['node_id'] = np.arange(nag[1].num_nodes, dtype=np.int64)
    nag = sort_nag_by_super(nag)
    levels = []
    caps = {}
    for i in nag.levels:
        n = nag[i].num_nodes
        caps[i] = (node_caps or {}).get(i) or bucket(n, bucket_mode)
    num_graphs = 1
    for i in nag.levels:
        d = nag[i]
        n = d.num_nodes
        cap = caps[i]
        pad = cap - n
        if pad < 0:
            raise ValueError(f'pad_nag: level {i} has {n} nodes, more '
                             f'than its capacity {cap}')

        def pad0(a, fill=0.0, dtype=None):
            a = np.asarray(a)
            if dtype is not None:
                a = a.astype(dtype)
            if pad == 0:
                return a
            width = [(0, pad)] + [(0, 0)] * (a.ndim - 1)
            return np.pad(a, width, constant_values=fill)

        pos = pad0(d.pos, dtype=np.float32)
        mask = np.zeros(cap, dtype=bool)
        mask[:n] = True
        batch_vec = d.get('batch')
        if batch_vec is None:
            batch_vec = np.zeros(n, dtype=np.int64)
        num_graphs = max(num_graphs, int(batch_vec.max()) + 1 if n else 1)
        # padded nodes get graph id -1 so graph-wise norms don't mix
        # them with real graphs
        batch_arr = np.full(cap, -1, dtype=np.int32)
        batch_arr[:n] = batch_vec.astype(np.int32)

        kw = {}
        if 'node_id' in d:
            nid = np.full(cap, -1, dtype=np.int32)
            nid[:n] = d.node_id.astype(np.int32)
            kw['node_id'] = nid
        if 'x' in d:
            kw['x'] = pad0(d.x, dtype=np.float32)
        if 'node_size' in d:
            kw['node_size'] = pad0(
                d.node_size.reshape(-1), dtype=np.float32)
        if 'super_index' in d and i < nag.end_i_level:
            si = np.full(cap, caps[i + 1], dtype=np.int32)
            si[:n] = d.super_index.astype(np.int32)
            kw['super_index'] = si
        if 'v_edge_attr' in d:
            kw['v_edge_attr'] = pad0(d.v_edge_attr, dtype=np.float32)
        y = d.get('y')
        if y is not None:
            y = np.asarray(y)
            if y.ndim == 1 and num_classes is not None:
                yy = np.zeros((n, num_classes + 1), dtype=np.float32)
                valid = (y >= 0) & (y <= num_classes)
                yy[np.arange(n)[valid], y[valid]] = 1.0
                y = yy
            kw['y'] = pad0(y.astype(np.float32))

        if i >= with_edges_from and 'edge_index' in d and d.num_edges > 0:
            k_cap = (k_caps or {}).get(i)
            nbr_idx, nbr_mask, edge_id = edges_to_dense_neighbors(
                d.edge_index, n, k=k_cap)
            K = nbr_idx.shape[1]
            full_idx = np.zeros((cap, K), dtype=np.int32)
            full_idx[:n] = nbr_idx
            full_mask = np.zeros((cap, K), dtype=bool)
            full_mask[:n] = nbr_mask
            kw['nbr_idx'] = full_idx
            kw['nbr_mask'] = full_mask
            if with_transpose:
                kw['nbr_in_idx'], kw['nbr_in_mask'] = transpose_neighbors(
                    full_idx, full_mask, (k_in_caps or {}).get(i, 0))
            ea = d.get('edge_attr')
            if ea is not None:
                # invalid slots keep whatever edge 0 carries: finite
                # values that the attention masks out by nbr_mask
                ef = np.zeros((cap, K, ea.shape[1]), dtype=np.float32)
                ef[:n] = ea.astype(np.float32, copy=False)[edge_id]
                kw['edge_feat'] = ef

        if 'coords' in d:
            # the sparse CNN's kernel-neighbor table of the level's
            # voxels, int32 on the host; padded rows see empty sites
            nbr = build_sparse_conv_neighbors(d.coords, batch=batch_vec)
            full = np.full((cap, nbr.shape[1]), -1, dtype=np.int32)
            full[:n] = nbr
            kw['cnn_nbr_idx'] = full

        if 'obj_edge_index' in d:
            oe = d.obj_edge_index
            e_cap = bucket(oe.shape[1], bucket_mode)
            oei = np.zeros((2, e_cap), dtype=np.int32)
            oei[:, :oe.shape[1]] = oe.astype(np.int32)
            oem = np.zeros(e_cap, dtype=bool)
            oem[:oe.shape[1]] = True
            kw['obj_edge_index'] = oei
            kw['obj_edge_mask'] = oem
            aff = d.get('obj_edge_affinity')
            if aff is not None:
                oea = np.zeros(e_cap, dtype=np.float32)
                oea[:aff.shape[0]] = aff.astype(np.float32)
                kw['obj_edge_affinity'] = oea

        levels.append(PaddedLevel(
            pos=pos, node_mask=mask, batch=batch_arr,
            num_nodes=np.int32(n), **kw))

    return PaddedNAG(levels=tuple(levels),
                     start_i_level=nag.start_i_level,
                     num_graphs=num_graphs)


def pad_point_cloud(data_list, num_classes=None, node_cap=None,
                    edge_cap=None, kernel_size=3, dilation=1,
                    bucket_mode='pow2'):
    """Collate and pad level-0 `Data` (pos, x, coords, edge_index, y) into
    one `PaddedPointCloud` with numpy leaves, for EZ-SP's partition
    stage; the sparse-convolution rulebook is built here, once a batch.
    Labels `y` are histograms [N, C+1], or ids one-hot encoded over
    `num_classes` + 1 columns (out-of-range ids give an empty row)."""
    node_off = np.cumsum([0] + [d.num_nodes for d in data_list])
    n = int(node_off[-1])
    pos = np.concatenate([np.asarray(d.pos) for d in data_list])
    x = np.concatenate(
        [np.asarray(d.x, np.float32) for d in data_list])
    batch_vec = np.concatenate([
        np.full(d.num_nodes, j, dtype=np.int64)
        for j, d in enumerate(data_list)])
    ei = np.concatenate([
        np.asarray(d.edge_index, np.int64) + node_off[j]
        for j, d in enumerate(data_list)], axis=1)
    coords = np.concatenate(
        [np.asarray(d.coords, np.int64) for d in data_list])
    nbr = build_sparse_conv_neighbors(
        coords, kernel_size=kernel_size, dilation=dilation,
        batch=batch_vec)

    cap = node_cap or bucket(n, bucket_mode)
    e_cap = edge_cap or bucket(ei.shape[1], bucket_mode)
    pad = cap - n
    if pad < 0 or e_cap < ei.shape[1]:
        raise ValueError(f'pad_point_cloud: {n} nodes and {ei.shape[1]} '
                         f'edges over capacities {cap} and {e_cap}')

    def padn(a, fill=0.0):
        if pad == 0:
            return a
        width = [(0, pad)] + [(0, 0)] * (a.ndim - 1)
        return np.pad(a, width, constant_values=fill)

    mask = np.zeros(cap, bool)
    mask[:n] = True
    batch_arr = np.full(cap, -1, np.int32)
    batch_arr[:n] = batch_vec
    nbr_full = np.full((cap, nbr.shape[1]), -1, np.int32)
    nbr_full[:n] = nbr
    eif = np.zeros((2, e_cap), np.int32)
    eif[:, :ei.shape[1]] = ei
    em = np.zeros(e_cap, bool)
    em[:ei.shape[1]] = True

    y = None
    ys = [d.get('y') for d in data_list]
    if all(v is not None for v in ys):
        ys = [np.asarray(v) for v in ys]
        if ys[0].ndim == 1:
            if num_classes is None:
                raise ValueError('pad_point_cloud: label ids need '
                                 'num_classes')
            hs = []
            for v in ys:
                h = np.zeros((v.shape[0], num_classes + 1), np.float32)
                valid = (v >= 0) & (v <= num_classes)
                h[np.arange(v.shape[0])[valid], v[valid]] = 1.0
                hs.append(h)
            y = np.concatenate(hs)
        else:
            y = np.concatenate(ys).astype(np.float32)
        y = padn(y)

    return PaddedPointCloud(
        pos=padn(pos.astype(np.float32)), x=padn(x), node_mask=mask,
        batch=batch_arr, num_nodes=n, cnn_nbr_idx=nbr_full,
        edge_index=eif, edge_mask=em, y=y)
