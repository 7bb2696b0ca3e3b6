"""Preprocessing on the host: raw point cloud -> hierarchical NAG. A
copy of the default path of the JAX package's `transforms/preprocess.py`
(the reference's `pre_transform` chain,
configs/datamodule/semantic/default.yaml:102-185):
  SaveNodeIndex -> GridSampling3D -> KNN -> PointFeatures ->
  GroundElevation -> AdjacencyGraph -> ConnectIsolated -> AddKeysTo ->
  CutPursuitPartition -> SegmentFeatures -> RadiusHorizontalGraph

The hot kernels (partition solver, radius KNN, eigen features, subedges)
run in the native library (`ops/native.py`); the orchestration is numpy.
EZ-SP's stage 2 swaps cut pursuit for the greedy contour-prior partition
(`partition_mode='contour_prior'`), over the embeddings of the frozen
stage-1 sparse CNN where a checkpoint is given (`pretrained_cnn_features`,
on a torch device). `knn_backend='device'` runs the KNN as torch ops on a
device (`ops/device_preprocess.py`). `graph_builder='delaunay'` swaps the
radius graph for the legacy Delaunay one; `ground_elevation` fits a
RANSAC plane, a KNN height or a small MLP; `grid_partition` is a regular
grid hierarchy in place of the partition.
"""
import os.path as osp

import numpy as np

from ..data.csr import Cluster, InstanceData
from ..data.data import Data
from ..data.nag import NAG
from ..ops.geometry import geometric_features_np
from ..ops.components import merge_components_by_contour_prior_np
from ..ops.graph import isolated_nodes_np, to_trimmed_np
from ..ops.native import greedy_cut, radius_knn
from ..ops.subedges import (_segment_csr, cluster_radius_nn_graph_np,
                            minimalistic_edge_features_np, subedges_np)
from ..utils.histogram import atomic_to_histogram
from ..utils.profiling import Timings

__all__ = [
    'save_node_index', 'grid_sampling', 'knn_search', 'point_features',
    'ground_elevation', 'adjacency_graph', 'connect_isolated',
    'add_keys_to', 'cut_pursuit_partition', 'segment_features',
    'radius_horizontal_graph', 'preprocess_cloud',
    'sample_xy_tiling', 'sample_recursive_main_xy_axis_tiling',
    'quantize_coordinates', 'greedy_contour_prior_partition',
    'pretrained_cnn_features', 'delaunay_horizontal_graph',
    'grid_partition', 'd0_partition_energy',
]

_VOTING_KEYS = ('y', 'super_index', 'is_val')
_INSTANCE_KEYS = ('obj', 'obj_pred')
_CLUSTER_KEYS = ('sub',)
_LAST_KEYS = ('batch', 'node_id')
_NORMAL_KEYS = ('normal',)


def save_node_index(data, key='sub'):
    """Store full-resolution point ids (reference SaveNodeIndex,
    src/transforms/sampling.py:56)."""
    data[key] = np.arange(data.num_nodes, dtype=np.int64)
    return data


def grid_sampling(data, size, hist_key='y', hist_size=None, mode='mean'):
    """Voxelize (reference GridSampling3D + _group_data,
    src/transforms/sampling.py:86,237): same-voxel points aggregate by
    key-specific rules — mean / majority voting ('y', 'super_index',
    'is_val') / histogram (hist_key) / Cluster ('sub') / InstanceData
    ('obj') / 'last' ('batch'); normals are re-normalized."""
    hist_keys = [hist_key] if isinstance(hist_key, str) else \
        list(hist_key or [])
    bins = {}
    if hist_size is not None:
        sizes = [hist_size] if isinstance(hist_size, int) else hist_size
        bins = dict(zip(hist_keys, sizes))

    coords = np.round(data.pos / size).astype(np.int64)
    # lexicographic voxel key
    mins = coords.min(0)
    coords = coords - mins
    dims = coords.max(0) + 1
    key = (coords[:, 0] * dims[1] + coords[:, 1]) * dims[2] + coords[:, 2]
    uniq, cluster, counts = np.unique(
        key, return_inverse=True, return_counts=True)
    n_vox = uniq.shape[0]
    # representative ("last"-style) point per voxel
    order = np.argsort(cluster, kind='stable')
    starts = np.zeros(n_vox + 1, dtype=np.int64)
    np.cumsum(counts, out=starts[1:])
    unique_pos_indices = order[starts[:-1]]

    out = Data()
    num_nodes = data.num_nodes
    for k, item in data.items():
        if k in _INSTANCE_KEYS:
            if isinstance(item, InstanceData):
                out._store[k] = item.merge(cluster)
            else:
                y = data.get('y')
                y = y if y is not None else np.zeros_like(item)
                out._store[k] = _instance_from_dense(cluster, item, y,
                                                     n_vox)
            continue
        if k in _CLUSTER_KEYS and item.ndim == 1:
            out._store[k] = Cluster(cluster, item, dense=True)
            continue
        if not isinstance(item, np.ndarray) or item.shape[0] != num_nodes:
            out._store[k] = item
            continue
        if mode == 'last' or k in _LAST_KEYS:
            out._store[k] = item[unique_pos_indices]
            continue
        if k in _VOTING_KEYS or k in bins:
            voting = k not in bins
            n_bins = int(item.max()) + 1 if voting else bins[k]
            hist = atomic_to_histogram(item, cluster, n_bins)
            out._store[k] = hist.argmax(-1) if voting else hist
            continue
        # mean aggregation
        v = item.astype(np.float64)
        acc = np.zeros((n_vox,) + v.shape[1:])
        np.add.at(acc, cluster, v)
        v = (acc / counts.reshape(-1, *([1] * (v.ndim - 1)))).astype(
            np.float32)
        if k in _NORMAL_KEYS:
            nn = np.linalg.norm(v, axis=1, keepdims=True)
            v = np.divide(v, nn, out=v, where=nn > 0)
        out._store[k] = v
    out['grid_size'] = np.array([size], dtype=np.float32)
    return out


def _instance_from_dense(cluster, obj, y, n_vox):
    """Build an InstanceData of (voxel -> overlapping instance) from
    dense per-point instance ids."""
    order = np.lexsort((obj, cluster))
    c, o, yy = cluster[order], obj[order], y[order]
    key = c.astype(np.int64) * (int(o.max()) + 1 if o.size else 1) + o
    uniq, first, counts = np.unique(key, return_index=True,
                                    return_counts=True)
    c_u, o_u, y_u = c[first], o[first], yy[first]
    ptr = np.zeros(n_vox + 1, dtype=np.int64)
    np.cumsum(np.bincount(c_u, minlength=n_vox), out=ptr[1:])
    return InstanceData(ptr, o_u, counts, y_u)


def _device_knn_grid(pos, r_max, reach=3):
    """The grid of the device KNN (the JAX `knn_search` device branch):
    a cell size `h` from the density (~4 points a cell over the bounding
    box), snapped to a power of two; `cell_cap` from the densest cell,
    snapped up to a power of two (a density-averaged cap would truncate
    the neighborhoods of clustered scans); the radius
    `min(r_max, h * reach)`. Returns (h, cell_cap, r)."""
    n = pos.shape[0]
    extent = np.maximum(pos.max(0) - pos.min(0), 1e-3)
    vol = float(np.prod(extent))
    h = (vol / max(n, 1) * 4.0) ** (1.0 / 3.0)
    h = float(2.0 ** np.round(np.log2(max(h, 1e-4))))
    cell = np.floor(pos / h).astype(np.int64)
    cell -= cell.min(0)
    dims = cell.max(0) + 1
    cid = (cell[:, 0] * dims[1] + cell[:, 1]) * dims[2] + cell[:, 2]
    occ = np.bincount(np.unique(cid, return_inverse=True)[1])
    cell_cap = int(2 ** np.ceil(np.log2(max(int(occ.max()), 8))))
    return h, cell_cap, float(min(r_max, h * reach))


def knn_search(data, k=45, r_max=2.0, backend='host', device='cuda'):
    """Fixed-radius KNN on the voxel centers (reference KNN transform,
    src/transforms/neighbors.py:11 over FRNN). Adds `neighbor_index`
    (-1 padded) and `neighbor_distance`.

    `backend='host'` is the native grid KNN (int32 `neighbor_index`).
    `backend='device'` is the grid-hash KNN of
    `ops/device_preprocess.py:grid_knn_device` on `device` (the card
    unless the caller asks for the CPU; without a card it raises), with
    the JAX package's grid (`_device_knn_grid`, a scan window of reach
    3) and an int64 `neighbor_index`."""
    if backend == 'device':
        import torch
        from ..ops.device_preprocess import grid_knn_device
        device = torch.device(device)
        if device.type == 'cuda' and not torch.cuda.is_available():
            raise RuntimeError('knn_search: no CUDA device; pass '
                               'device="cpu" to run the device KNN on the '
                               'CPU')
        pos = np.asarray(data.pos, np.float32)
        reach = 3
        h, cell_cap, r = _device_knn_grid(pos, r_max, reach)
        nbr, dist = grid_knn_device(
            torch.from_numpy(pos).to(device),
            torch.ones(pos.shape[0], dtype=torch.bool, device=device),
            r, int(k), cell_cap=cell_cap, reach=reach, cell_size=h,
            chunk=2048)
        data['neighbor_index'] = nbr.cpu().numpy().astype(np.int64)
        data['neighbor_distance'] = dist.cpu().numpy()
        return data
    if backend != 'host':
        raise ValueError(f"knn_search: backend={backend!r} ('host' or "
                         "'device')")
    nbr, dist = radius_knn(data.pos, r=r_max, k=k, exclude_self=True)
    # keep the kernel's int32: numpy fancy indexing takes it, and
    # nothing downstream needs int64
    data['neighbor_index'] = nbr
    data['neighbor_distance'] = dist
    return data


def point_features(data, keys=('linearity', 'planarity', 'scattering',
                               'verticality', 'elevation', 'rgb',
                               'normal'),
                   k_min=1, k_step=-1, k_min_search=25,
                   overwrite=True):
    """Per-point geometric + radiometric features (reference
    PointFeatures, src/transforms/point.py:41). Geometric features run
    on the host (ops.geometry.geometric_features_np)."""
    keys = list(keys or [])
    geof = {'linearity', 'planarity', 'scattering', 'verticality',
            'curvature', 'length', 'surface', 'volume', 'normal'}
    need_geof = [k for k in keys if k in geof]
    if need_geof:
        nbr = data.neighbor_index
        mask = nbr >= 0
        # raw_invalid: the KNN table already carries -1 at invalid
        # slots — the native eigen path consumes it with one int32
        # cast instead of a maximum() + where() + concat round-trip
        feats = geometric_features_np(
            data.pos, nbr, mask,
            k_min=max(k_min, 1), k_step=k_step,
            k_min_search=k_min_search, raw_invalid=True)
        for k in need_geof:
            if overwrite or k not in data:
                data[k] = np.asarray(feats[k], dtype=np.float32)
    if 'density' in keys:
        nbr = data.neighbor_index
        k_eff = (nbr >= 0).sum(1)
        dmax = np.where(np.isfinite(data.neighbor_distance),
                        data.neighbor_distance, 0).max(1)
        data['density'] = (
            k_eff / np.maximum(dmax, 1e-6) ** 2).reshape(-1, 1).astype(
            np.float32)
    # rgb/hsv/lab handled by the dataset readers; 'elevation' by
    # ground_elevation()
    return data


def ground_elevation(data, z_threshold=1.5, xy_grid=1.0, scale=4.0,
                     iterations=200, margin=0.1, rng=None,
                     model='ransac', knn_k=10):
    """Estimate the ground and store per-point scaled elevation
    (reference GroundElevation, src/transforms/point.py:185 +
    src/utils/ground.py RANSAC :100 / knn :154 / mlp :219 models).
    Candidate ground points: lowest-z per xy cell, below z_threshold
    above the global minimum. `model='ransac'` fits one plane;
    `model='knn'` takes the mean height of the `knn_k` nearest ground
    candidates in XY, for non-planar terrain (DALES-style tiles);
    `model='mlp'` fits a piecewise-planar surface z = f(x, y) with a
    small MLP (`_mlp_ground_fit`)."""
    if model not in ('ransac', 'knn', 'mlp'):
        raise ValueError(f'ground_elevation: unknown model {model!r}')
    rng = rng or np.random.default_rng(0)
    pos = data.pos
    z0 = pos[:, 2].min()
    cand = pos[pos[:, 2] < z0 + z_threshold]
    if xy_grid and xy_grid > 0 and cand.shape[0] > 1000:
        cells = np.floor(cand[:, :2] / xy_grid).astype(np.int64)
        key = cells[:, 0] * (cells[:, 1].max() - cells[:, 1].min() + 2) \
            + cells[:, 1]
        order = np.lexsort((cand[:, 2], key))
        k_sorted = key[order]
        first = np.ones(order.shape[0], dtype=bool)
        first[1:] = k_sorted[1:] != k_sorted[:-1]
        cand = cand[order[first]]
    if cand.shape[0] < 3:
        data['elevation'] = np.zeros((pos.shape[0], 1), dtype=np.float32)
        return data
    if model == 'knn':
        # local ground height: mean z of the k nearest candidates in XY
        cand_xy = np.concatenate(
            [cand[:, :2], np.zeros((cand.shape[0], 1), np.float32)], 1)
        query_xy = np.concatenate(
            [pos[:, :2], np.zeros((pos.shape[0], 1), np.float32)], 1)
        nbr, _ = radius_knn(cand_xy.astype(np.float32),
                            query_xy.astype(np.float32), r=np.inf,
                            k=min(knn_k, cand.shape[0]), exclude_self=False)
        valid = nbr >= 0
        z_nb = np.where(valid, cand[np.maximum(nbr, 0), 2], 0.0)
        ground_z = z_nb.sum(1) / np.maximum(valid.sum(1), 1)
    elif model == 'mlp':
        ground_z = _mlp_ground_fit(cand, pos, rng=rng)
    if model != 'ransac':
        data['elevation'] = ((pos[:, 2] - ground_z) / scale).reshape(
            -1, 1).astype(np.float32)
        return data
    best_inliers, best_plane = -1, None
    n = cand.shape[0]
    for _ in range(iterations):
        idx = rng.choice(n, 3, replace=False)
        p0, p1, p2 = cand[idx]
        nrm = np.cross(p1 - p0, p2 - p0)
        nn = np.linalg.norm(nrm)
        if nn < 1e-9:
            continue
        nrm = nrm / nn
        if abs(nrm[2]) < 0.5:
            continue  # reject steep planes
        d = -nrm @ p0
        dist = np.abs(cand @ nrm + d)
        inliers = (dist < margin).sum()
        if inliers > best_inliers:
            best_inliers, best_plane = inliers, (nrm, d)
    if best_plane is None:
        data['elevation'] = ((pos[:, 2] - z0) / scale).reshape(
            -1, 1).astype(np.float32)
        return data
    nrm, d = best_plane
    sign = np.sign(nrm[2]) or 1.0
    elev = (pos @ nrm + d) * sign / scale
    data['elevation'] = elev.reshape(-1, 1).astype(np.float32)
    return data


def _mlp_ground_fit(cand, pos, layers=(32, 16, 8), steps=500, lr=0.01,
                    weight_decay=0.01, rng=None):
    """Fit z = f(x, y) on the ground candidates with a small tanh MLP
    trained by full-batch Adam on an L2 loss, in float64 numpy on the
    host (reference mlp_model, src/utils/ground.py:219: the same
    normalization by mean and std), and predict the ground height under
    every point. Returns the ground z per point in original units."""
    rng = rng or np.random.default_rng(0)
    mean = cand.mean(0)
    std = cand.std(0) + 1e-6
    xy = ((cand[:, :2] - mean[:2]) / std[:2]).astype(np.float64)
    z = ((cand[:, 2] - mean[2]) / std[2]).astype(np.float64)

    dims = [2] + list(layers) + [1]
    params = [[rng.normal(0, np.sqrt(2.0 / dims[i]), (dims[i], dims[i + 1])),
               np.zeros(dims[i + 1])] for i in range(len(dims) - 1)]

    def forward(x):
        acts = [x]
        for i, (w, b) in enumerate(params):
            x = x @ w + b
            if i < len(params) - 1:
                x = np.tanh(x)
            acts.append(x)
        return x[:, 0], acts

    ms = [[np.zeros_like(w), np.zeros_like(b)] for w, b in params]
    vs = [[np.zeros_like(w), np.zeros_like(b)] for w, b in params]
    b1, b2, eps = 0.9, 0.999, 1e-8
    for t in range(1, steps + 1):
        pred, acts = forward(xy)
        g = (pred - z)[:, None] * (2.0 / xy.shape[0])
        grads = []
        for i in range(len(params) - 1, -1, -1):
            w, _ = params[i]
            grads.append((acts[i].T @ g + weight_decay * w, g.sum(0)))
            if i > 0:
                g = (g @ w.T) * (1.0 - acts[i] ** 2)
        for i, gs in enumerate(grads[::-1]):
            for j, gj in enumerate(gs):
                ms[i][j] = b1 * ms[i][j] + (1 - b1) * gj
                vs[i][j] = b2 * vs[i][j] + (1 - b2) * gj ** 2
                mh = ms[i][j] / (1 - b1 ** t)
                vh = vs[i][j] / (1 - b2 ** t)
                params[i][j] -= lr * mh / (np.sqrt(vh) + eps)

    q = ((pos[:, :2] - mean[:2]) / std[:2]).astype(np.float64)
    pred, _ = forward(q)
    return (pred * std[2] + mean[2]).astype(np.float32)


def adjacency_graph(data, k=10, w=1.0):
    """Point adjacency graph from KNN (reference AdjacencyGraph,
    src/transforms/graph.py:45): directed edges to the k nearest
    neighbors, weights 1/(w + d/mean(d))."""
    nbr = data.neighbor_index[:, :k]
    dist = data.neighbor_distance[:, :k]
    n = data.num_nodes
    src = np.repeat(np.arange(n, dtype=np.int64), k)
    dst = nbr.reshape(-1)
    valid = dst >= 0
    src, dst = src[valid], dst[valid]
    data['edge_index'] = np.stack([src, dst])
    if w > 0:
        d = dist.reshape(-1)[valid]
        data['edge_attr'] = (1.0 / (w + d / d.mean())).astype(np.float32)
    else:
        data['edge_attr'] = np.ones(src.shape[0], dtype=np.float32)
    return data


def connect_isolated(data, k=1):
    """Connect isolated nodes to their nearest neighbors (reference
    ConnectIsolated / Data.connect_isolated, src/data/data.py:481)."""
    n = data.num_nodes
    if 'edge_index' not in data or n < 2:
        return data
    iso = isolated_nodes_np(data.edge_index, n)
    if not iso.any():
        return data
    iso_idx = np.where(iso)[0]
    # query k+1: the query points exist in the search set, so the
    # nearest hit is the node itself and must be skipped
    nbr, dist = radius_knn(data.pos, data.pos[iso_idx], r=1e9,
                           k=k + 1, exclude_self=False)
    new_s, new_t, new_w = [], [], []
    for row, i in enumerate(iso_idx):
        found = 0
        for j in range(k + 1):
            t = nbr[row, j]
            if t < 0 or t == i or found >= k:
                continue
            found += 1
            new_s.append(i)
            new_t.append(t)
            new_w.append(1.0)
    if new_s:
        ei = np.stack([np.asarray(new_s), np.asarray(new_t)])
        data['edge_index'] = np.concatenate([data.edge_index, ei], 1)
        if 'edge_attr' in data and data.edge_attr.ndim == 1:
            data['edge_attr'] = np.concatenate(
                [data.edge_attr, np.asarray(new_w, dtype=np.float32)])
    return data


def add_keys_to(data, keys, to='x', delete_after=False):
    """Concatenate named attributes into `to` (reference AddKeysTo)."""
    feats = []
    existing = data.get(to)
    if existing is not None:
        feats.append(existing.reshape(existing.shape[0], -1))
    for k in keys:
        v = data.get(k)
        if v is None:
            raise KeyError(k)
        v = v.reshape(v.shape[0], -1).astype(np.float32)
        if k == 'rgb' and v.max() > 1.5:
            v = v / 255.0
        feats.append(v)
        if delete_after:
            del data._store[k]
    data[to] = np.concatenate(feats, axis=1)
    return data


def cut_pursuit_partition(
        data, regularization=(0.01, 0.1, 0.5),
        spatial_weight=(0.1, 0.1, 0.1), cutoff=(10, 10, 10),
        k_adjacency=5, edge_reduce='mean', verbose=False):
    """Hierarchical superpoint partition (reference CutPursuitPartition,
    src/transforms/partition.py:22): per level, trim the graph, solve
    the L0 partition on [spatial_weight*(pos-mean) | x] with
    reg-scaled edge weights (native greedy solver, see
    native/greedy_cut.cpp), rebuild the level Data (centroids, feature
    means, cluster CSR, reduced graph), aggregate label histograms,
    connect isolated nodes. Returns a NAG."""
    regs = list(np.atleast_1d(regularization))
    sws = list(np.atleast_1d(spatial_weight))
    cuts = list(np.atleast_1d(cutoff))
    if len(sws) == 1:
        sws = sws * len(regs)
    if len(cuts) == 1:
        cuts = cuts * len(regs)

    d1 = data
    d1['node_size'] = np.ones(d1.num_nodes, dtype=np.int64)
    levels = [d1]
    for level, (reg, cut, sw) in enumerate(zip(regs, cuts, sws)):
        d1 = levels[level]
        if d1.num_nodes < 2:
            break
        ei, ea = to_trimmed_np(
            d1.edge_index.astype(np.int64),
            d1.edge_attr.reshape(-1, 1) if d1.get('edge_attr') is not None
            and d1.edge_attr.ndim == 1 else d1.get('edge_attr'),
            reduce=edge_reduce)
        pos_offset = d1.pos.mean(0)
        feats = [(d1.pos - pos_offset) * sw]
        if d1.get('x') is not None:
            feats.append(d1.x)
        f = np.concatenate(feats, 1).astype(np.float32)
        ew = (ea.reshape(-1) * reg) if ea is not None else None
        node_w = d1.node_size.astype(np.float32)
        super_index, n_comp = greedy_cut(
            f, ei, edge_weight=(ea.reshape(-1) if ea is not None
                                else None),
            node_weight=node_w, reg=reg, cutoff=cut)
        if verbose:
            print(f'level {level}: {d1.num_nodes} -> {n_comp}')
        d1['super_index'] = super_index

        # component stats (bincount per column: C-speed scatter-add)
        S = np.bincount(super_index, weights=node_w,
                        minlength=n_comp)
        fw = f * node_w[:, None]
        mu = np.stack([
            np.bincount(super_index, weights=fw[:, j],
                        minlength=n_comp)
            for j in range(f.shape[1])], axis=1)
        mu = mu / S[:, None]
        pos_c = mu[:, :3] / sw + pos_offset
        x_c = mu[:, 3:] if f.shape[1] > 3 else None

        # reduced graph: cross-component edges with accumulated weight
        cs, ct = super_index[ei[0]], super_index[ei[1]]
        cross = cs != ct
        if cross.any():
            red_ei = np.stack([cs[cross], ct[cross]])
            red_ea = (ea.reshape(-1)[cross] if ea is not None
                      else np.ones(cross.sum(), dtype=np.float32))
            red_ei, red_ea = to_trimmed_np(
                red_ei, red_ea.reshape(-1, 1), reduce='sum')
            red_ea = red_ea.reshape(-1)
        else:
            red_ei = np.zeros((2, 0), dtype=np.int64)
            red_ea = np.zeros(0, dtype=np.float32)

        node_size_new = np.bincount(
            super_index, weights=d1.node_size.astype(np.float64),
            minlength=n_comp).astype(np.int64)

        d2 = Data(
            pos=pos_c.astype(np.float32),
            edge_index=red_ei,
            edge_attr=red_ea.astype(np.float32),
            sub=Cluster(super_index, np.arange(d1.num_nodes),
                        dense=True),
            node_size=node_size_new)
        if x_c is not None:
            d2['x'] = x_c.astype(np.float32)
        if d1.get('obj') is not None and isinstance(d1.obj, InstanceData):
            d2['obj'] = d1.obj.merge(super_index)
        if d2.num_nodes > 1:
            d2 = connect_isolated(d2, k=k_adjacency)
        y = d1.get('y')
        if y is not None:
            assert y.ndim == 2, "expects label histograms"
            acc = np.stack([
                np.bincount(super_index, weights=y[:, j],
                            minlength=n_comp)
                for j in range(y.shape[1])], axis=1).astype(np.int64)
            d2['y'] = acc
        levels.append(d2)
    return NAG(levels, start_i_level=0)


def d0_partition_energy(features, edge_index, edge_weight, node_weight,
                        super_index, reg):
    """L0/d0 partition energy (the objective cp_d0_dist minimizes,
    reference src/transforms/partition.py:199-227):
    sum_v w_v * ||f_v - mu_{comp(v)}||^2 + reg * sum of cut-edge weights,
    in float64. Returns (total, fidelity, reg * cut)."""
    f = np.asarray(features, dtype=np.float64)
    nw = np.asarray(node_weight, dtype=np.float64).reshape(-1)
    sup = np.asarray(super_index)
    n_comp = int(sup.max()) + 1
    S = np.zeros(n_comp)
    np.add.at(S, sup, nw)
    mu = np.zeros((n_comp, f.shape[1]))
    np.add.at(mu, sup, f * nw[:, None])
    mu /= np.maximum(S, 1e-12)[:, None]
    fidelity = float((nw[:, None] * (f - mu[sup]) ** 2).sum())
    cross = sup[edge_index[0]] != sup[edge_index[1]]
    cut = float(np.asarray(edge_weight).reshape(-1)[cross].sum())
    return fidelity + reg * cut, fidelity, reg * cut


def segment_features(nag, n_max=32, n_min=5,
                     keys=('normal', 'log_length', 'log_surface',
                           'log_volume', 'log_size'),
                     mean_keys=(), std_keys=(), strict=False,
                     rng=None):
    """Per-segment geometric features from sampled member points
    (reference SegmentFeatures / _compute_cluster_features,
    src/transforms/graph.py:117-325)."""
    rng = rng or np.random.default_rng(0)
    keys = list(keys or [])
    for i_level in range(1, nag.absolute_num_levels):
        d = nag[i_level]
        num_nodes = d.num_nodes
        sub_size = nag.get_sub_size(i_level, low=0)
        sup = nag.get_super_index(i_level, low=0)
        samples, ptr = _sample_per_segment(sup, num_nodes, n_max, n_min,
                                           rng)
        xyz = nag[0].pos + rng.random(nag[0].pos.shape).astype(
            np.float32) * 1e-8
        sizes = ptr[1:] - ptr[:-1]
        K = int(sizes.max())
        # CSR -> dense [num_nodes, K] without a python loop
        seg_of = np.repeat(np.arange(num_nodes), sizes)
        rank = np.arange(samples.shape[0]) - ptr[seg_of]
        nbr = np.full((num_nodes, K), -1, dtype=np.int64)
        nbr[seg_of, rank] = samples
        geof_needed = [k for k in keys
                       if k.replace('log_', '') in
                       ('linearity', 'planarity', 'scattering',
                        'verticality', 'curvature', 'length', 'surface',
                        'volume', 'normal')]
        if geof_needed:
            feats = geometric_features_np(
                xyz, np.maximum(nbr, 0), nbr >= 0, k_min=1,
                add_self=False)
            for k in geof_needed:
                base = k[4:] if k.startswith('log_') else k
                v = np.asarray(feats[base], dtype=np.float32)
                d[k] = np.log(v + 1) if k.startswith('log_') else v
        if 'log_size' in keys:
            d['log_size'] = ((np.log(sub_size + 1).reshape(-1, 1)
                              - np.log(2)) / 10).astype(np.float32)
        for k in mean_keys:
            v = nag[0].get(k)
            if v is None:
                if strict:
                    raise KeyError(k)
                continue
            acc = np.zeros((num_nodes,) + v.shape[1:])
            np.add.at(acc, sup, v)
            cnt = np.bincount(sup, minlength=num_nodes).astype(
                np.float64).reshape(-1, *([1] * (v.ndim - 1)))
            m = (acc / np.maximum(cnt, 1)).astype(np.float32)
            if k == 'normal':
                # mean orientation: flip to a canonical halfspace first
                vv = v * np.sign(v[:, 2:3] + 1e-12)
                acc = np.zeros((num_nodes, 3))
                np.add.at(acc, sup, vv)
                m = (acc / np.maximum(cnt, 1)).astype(np.float32)
                nn = np.linalg.norm(m, axis=1, keepdims=True)
                m = np.divide(m, nn, out=m, where=nn > 0)
            d[f'mean_{k}'] = m
        for k in std_keys:
            v = nag[0].get(k)
            if v is None:
                if strict:
                    raise KeyError(k)
                continue
            cnt = np.bincount(sup, minlength=num_nodes).astype(np.float64)
            acc = np.zeros((num_nodes,) + v.shape[1:])
            np.add.at(acc, sup, v.astype(np.float64))
            mean = acc / np.maximum(cnt, 1).reshape(
                -1, *([1] * (v.ndim - 1)))
            dev = (v - mean[sup]) ** 2
            acc2 = np.zeros_like(acc)
            np.add.at(acc2, sup, dev)
            var = acc2 / np.maximum(cnt - 1, 1).reshape(
                -1, *([1] * (v.ndim - 1)))
            d[f'std_{k}'] = np.sqrt(var).astype(np.float32)
    return nag


def _sample_per_segment(sup, num_seg, n_max, n_min, rng):
    """Sample up to n_max (at least min(count, n_min)) point ids per
    segment; returns (flat sample ids, CSR pointers)."""
    counts = np.bincount(sup, minlength=num_seg)
    order = np.argsort(sup, kind='stable')
    starts = np.zeros(num_seg + 1, dtype=np.int64)
    np.cumsum(counts, out=starts[1:])
    budget = np.minimum(np.clip(counts, n_min, n_max), counts)
    r = rng.random(sup.shape[0])
    seg_sorted = np.lexsort((r, sup))
    rank = np.empty(sup.shape[0], dtype=np.int64)
    rank[seg_sorted] = np.arange(sup.shape[0]) - starts[sup[seg_sorted]]
    keep = rank < budget[sup]
    samples = np.where(keep)[0]
    samples = samples[np.argsort(sup[samples], kind='stable')]
    ptr = np.zeros(num_seg + 1, dtype=np.int64)
    np.cumsum(np.bincount(sup[samples], minlength=num_seg), out=ptr[1:])
    return samples, ptr


def radius_horizontal_graph(
        nag, k_min=1, k_max=30, gap=(0.2, 0.5, 1.0), se_ratio=0.3,
        se_min=20, cycles=3, margin=0.2, halfspace_filter=True,
        bbox_filter=True, target_pc_flip=True, source_pc_sort=False,
        chunk_size=100_000, rng=None):
    """Superpoint adjacency graph + minimalistic edge features
    (reference RadiusHorizontalGraph, src/transforms/graph.py:594).

    For each level 1+: find neighboring segment pairs by bbox-center
    KNN refined with iterative anchor nearest-neighbor search and the
    `gap` criterion (cluster_radius_nn_graph), connect isolated nodes
    to their k_min nearest segments, then build the reference's
    subedges (halfspace + bbox filters, top ratio.size points sorted
    along principal components — src/utils/graph.py:99) and compute
    the 7-dim minimalistic edge features
    [mean_off(3) | std_off(3) | sqrt(mean_dist)(1)]
    (src/transforms/graph.py:957). Edges are processed in chunks of
    `chunk_size` to bound the point-edge expansion memory."""
    del rng  # deterministic: kept for call-site compatibility
    gaps = list(np.atleast_1d(gap))
    while len(gaps) < nag.absolute_num_levels - 1:
        gaps.append(gaps[-1])
    k_maxs = list(np.atleast_1d(k_max))
    while len(k_maxs) < nag.absolute_num_levels - 1:
        k_maxs.append(k_maxs[-1])
    pos0 = np.asarray(nag[0].pos, dtype=np.float64)
    for i_level in range(1, nag.absolute_num_levels):
        d = nag[i_level]
        g = float(gaps[i_level - 1])
        num_seg = d.num_nodes
        sup = nag.get_super_index(i_level, low=0)
        csr = _segment_csr(sup, num_seg)
        ei, _ = cluster_radius_nn_graph_np(
            pos0, sup, k_max=int(k_maxs[i_level - 1]), gap=g,
            cycles=cycles, csr=csr)
        # connect isolated nodes to their k_min nearest segments
        d['edge_index'] = ei
        d.edge_attr = None  # attribute-set pops the key
        connect_isolated(d, k=k_min)
        ei, _ = to_trimmed_np(d['edge_index'])
        # subedges + features, chunked over edges
        ei_parts, ea_parts = [], []
        for lo in range(0, ei.shape[1], int(chunk_size)):
            part = ei[:, lo:lo + int(chunk_size)]
            se, pairs, uid = subedges_np(
                pos0, sup, part, ratio=se_ratio, k_min=se_min,
                cycles=cycles, margin=margin,
                halfspace_filter=halfspace_filter,
                bbox_filter=bbox_filter,
                target_pc_flip=target_pc_flip,
                source_pc_sort=source_pc_sort, csr=csr)
            ei_parts.append(se)
            ea_parts.append(minimalistic_edge_features_np(
                pos0, pairs, uid, se.shape[1]))
        d['edge_index'] = np.concatenate(ei_parts, axis=1) \
            if ei_parts else np.zeros((2, 0), dtype=np.int64)
        d['edge_attr'] = np.concatenate(ea_parts, axis=0) \
            if ea_parts else np.zeros((0, 7), dtype=np.float32)
    return nag


def _empty_graph(d):
    d['edge_index'] = np.zeros((2, 0), dtype=np.int64)
    d['edge_attr'] = np.zeros((0, 7), dtype=np.float32)


def delaunay_horizontal_graph(nag, n_max_edge=64, n_min=5,
                              max_dist=-1, rng=None):
    """Legacy horizontal graph from the dual of a Delaunay triangulation
    of per-segment point samples (reference DelaunayHorizontalGraph,
    src/transforms/graph.py:324 + _horizontal_graph_by_delaunay :399).
    Slower, visibility-based alternative to `radius_horizontal_graph`.

    Per level >= 1: sample level-0 points near segment boundaries (points
    touching inter-segment level-0 adjacency edges; whole segments when
    isolated), jitter them by N(0, 1e-9), triangulate them (Qhull,
    'QJ'), keep the simplex edges that span two segments, trim to i<j,
    and compute the 7-dim minimalistic features
    [mean_off | std_off | mean_dist] (the mean distance itself, where the
    radius graph stores its square root). `rng` is drawn from in that
    order: the sampling, then the jitter. `max_dist > 0` drops long
    edges but keeps the shortest edge of each node the filter would
    isolate (reference graph.py:356-361). The degree is not capped."""
    from scipy.spatial import Delaunay, QhullError

    rng = rng or np.random.default_rng(0)
    mds = list(np.atleast_1d(max_dist).astype(np.float64))
    while len(mds) < nag.absolute_num_levels - 1:
        mds.append(mds[-1])
    pos0 = nag[0].pos
    n0 = pos0.shape[0]
    for i_level in range(1, nag.absolute_num_levels):
        d = nag[i_level]
        num_seg = d.num_nodes
        if num_seg < 2:
            _empty_graph(d)
            continue
        sup = nag.get_super_index(i_level, low=0)
        # guided sampling: points on inter-segment level-0 edges;
        # isolated segments contribute all their points
        mask = np.ones(n0, dtype=bool)
        ei0 = nag[0].get('edge_index')
        if ei0 is not None and ei0.shape[1] > 0:
            s0, t0 = sup[ei0[0]], sup[ei0[1]]
            inter = s0 != t0
            mask = np.zeros(n0, dtype=bool)
            mask[np.unique(ei0[:, inter])] = True
            seg_has = np.zeros(num_seg, dtype=bool)
            seg_has[s0[inter]] = True
            seg_has[t0[inter]] = True
            mask |= ~seg_has[sup]
        cand = np.flatnonzero(mask)
        local, _ = _sample_per_segment(
            sup[cand], num_seg, n_max_edge, n_min, rng)
        samples = cand[local]
        pts = pos0[samples].astype(np.float64)
        pts = pts + rng.normal(0, 1e-9, pts.shape)
        try:
            tri = Delaunay(pts, qhull_options='QJ')
        except (QhullError, ValueError):
            _empty_graph(d)
            continue
        simp = tri.simplices
        pairs = [(a, b) for a in range(simp.shape[1])
                 for b in range(a + 1, simp.shape[1])]
        src_pt = np.concatenate([simp[:, a] for a, b in pairs])
        dst_pt = np.concatenate([simp[:, b] for a, b in pairs])
        ss, tt = sup[samples[src_pt]], sup[samples[dst_pt]]
        cross = ss != tt
        src_pt, dst_pt = src_pt[cross], dst_pt[cross]
        ss, tt = ss[cross], tt[cross]
        if ss.shape[0] == 0:
            _empty_graph(d)
            continue
        off = (pos0[samples[dst_pt]]
               - pos0[samples[src_pt]]).astype(np.float64)
        dd = np.linalg.norm(off, axis=1)
        flip = ss > tt
        s2, t2 = ss.copy(), tt.copy()
        s2[flip], t2[flip] = tt[flip], ss[flip]
        off[flip] = -off[flip]
        pair_key = s2.astype(np.int64) * num_seg + t2
        uniq, inv = np.unique(pair_key, return_inverse=True)
        n_pairs = uniq.shape[0]
        cnt = np.bincount(inv, minlength=n_pairs).astype(np.float64)
        mean_off = np.stack(
            [np.bincount(inv, weights=off[:, c], minlength=n_pairs)
             for c in range(3)], 1)
        mean_off /= cnt[:, None]
        dev = (off - mean_off[inv]) ** 2
        var = np.stack(
            [np.bincount(inv, weights=dev[:, c], minlength=n_pairs)
             for c in range(3)], 1)
        std_off = np.sqrt(var / np.maximum(cnt - 1, 1)[:, None])
        mean_dist = np.bincount(inv, weights=dd, minlength=n_pairs)
        mean_dist /= cnt
        se = np.stack([uniq // num_seg, uniq % num_seg])
        md = mds[i_level - 1]
        if md > 0:
            keep = mean_dist <= md
            # keep the shortest edge of any node the filter would isolate
            for side in (0, 1):
                ids = se[side]
                kept_deg = np.bincount(ids[keep], minlength=num_seg)
                lost = np.isin(ids, np.flatnonzero(
                    (np.bincount(ids, minlength=num_seg) > 0)
                    & (kept_deg == 0)))
                if lost.any():
                    order = np.lexsort((mean_dist, ids))
                    first = np.ones(order.shape[0], dtype=bool)
                    first[1:] = ids[order][1:] != ids[order][:-1]
                    shortest = np.zeros(ids.shape[0], dtype=bool)
                    shortest[order[first]] = True
                    keep |= lost & shortest
            se = se[:, keep]
            mean_off, std_off = mean_off[keep], std_off[keep]
            mean_dist = mean_dist[keep]
        d['edge_index'] = se.astype(np.int64)
        d['edge_attr'] = np.concatenate(
            [mean_off, std_off, mean_dist.reshape(-1, 1)],
            1).astype(np.float32)
    return nag


def preprocess_cloud(
        data, voxel=0.03, knn=45, knn_r=2.0, knn_step=-1,
        knn_min_search=25, knn_backend='host', num_classes=13,
        partition_hf=('rgb', 'linearity', 'planarity', 'scattering',
                      'verticality', 'elevation'),
        point_hf_preprocess=('linearity', 'planarity', 'scattering',
                             'verticality', 'elevation', 'normal'),
        pcp_regularization=(0.01, 0.1, 0.5),
        pcp_spatial_weight=(0.1, 0.1, 0.1),
        pcp_cutoff=(10, 10, 10), pcp_k_adjacency=10, pcp_w_adjacency=1,
        graph_k_min=1, graph_k_max=30, graph_gap=(0.2, 0.5, 1.0),
        ground_threshold=1.5, ground_scale=4.0,
        segment_mean_hf=(), segment_std_hf=(), rng=None,
        partition_mode='cut_pursuit', pretrained_cnn_ckpt_path=None,
        pretrained_cnn_channels=(32, 32, 32), contour_prior_reg=2e-2,
        contour_prior_min_size=(5, 30, 90),
        contour_prior_edge_weight_mode='exp_neg_latent_distance',
        contour_prior_k_isolated=5, with_instances=False,
        graph_builder='radius', graph_delaunay_max_dist=-1,
        device='cuda', verbose=False):
    """Full raw-cloud -> NAG preprocessing (the reference `pre_transform`
    chain) with the JAX `preprocess_cloud`'s defaults: cut-pursuit
    partition, radius horizontal graph, host KNN.
    `graph_builder='delaunay'` builds the legacy Delaunay graph instead
    (`delaunay_horizontal_graph`, with `graph_delaunay_max_dist`). `verbose=True` prints
    per-stage wall times. Per-point instance ids in `data['obj']` become
    the `obj` InstanceData of every level; `with_instances` is accepted
    as the JAX function accepts it and changes nothing.

    `partition_mode='contour_prior'` is EZ-SP's stage 2: the greedy
    contour-prior partition on the partition features, or, given
    `pretrained_cnn_ckpt_path` (a stage-1 checkpoint of this package),
    on the embeddings of its frozen sparse CNN. The CNN and
    `knn_backend='device'`'s KNN run on `device`, the card unless the
    caller asks for the CPU: the one argument the JAX function lacks, and
    no part of a cache's hash."""
    if partition_mode not in ('cut_pursuit', 'contour_prior'):
        raise ValueError(f'unknown partition_mode {partition_mode!r}')
    t = Timings()
    rng = rng or np.random.default_rng(0)
    with t.track('save_node_index'):
        data = save_node_index(data, key='sub')
    with t.track('grid_sampling'):
        data = grid_sampling(data, voxel, hist_key='y',
                             hist_size=num_classes + 1)
    with t.track('knn_search'):
        data = knn_search(data, k=knn, r_max=knn_r, backend=knn_backend,
                          device=device)
    with t.track('point_features'):
        data = point_features(data, keys=point_hf_preprocess,
                              k_step=knn_step,
                              k_min_search=knn_min_search)
    with t.track('ground_elevation'):
        data = ground_elevation(data, z_threshold=ground_threshold,
                                scale=ground_scale, rng=rng)
    with t.track('adjacency_graph'):
        data = adjacency_graph(data, k=pcp_k_adjacency,
                               w=pcp_w_adjacency)
        data = connect_isolated(data, k=1)
        data = add_keys_to(data, list(partition_hf), to='x',
                           delete_after=False)
    if partition_mode == 'contour_prior':
        if pretrained_cnn_ckpt_path:
            with t.track('pretrained_cnn'):
                data = quantize_coordinates(data, size=voxel)
                data = pretrained_cnn_features(
                    data, ckpt_path=pretrained_cnn_ckpt_path,
                    channels=pretrained_cnn_channels, voxel=voxel,
                    key='x', out_key='x', device=device)
        with t.track('greedy_contour_prior_partition'):
            nag = greedy_contour_prior_partition(
                data, reg=contour_prior_reg,
                min_size=contour_prior_min_size,
                edge_weight_mode=contour_prior_edge_weight_mode,
                k=contour_prior_k_isolated)
    else:
        with t.track('cut_pursuit_partition'):
            nag = cut_pursuit_partition(
                data, regularization=pcp_regularization,
                spatial_weight=pcp_spatial_weight, cutoff=pcp_cutoff,
                k_adjacency=pcp_k_adjacency)
    for i in nag.levels:
        nag[i]._store.pop('x', None)
    with t.track('segment_features'):
        nag = segment_features(nag, mean_keys=segment_mean_hf,
                               std_keys=segment_std_hf, rng=rng)
    if graph_builder == 'delaunay':
        with t.track('delaunay_horizontal_graph'):
            nag = delaunay_horizontal_graph(
                nag, max_dist=graph_delaunay_max_dist, rng=rng)
    else:
        with t.track('radius_horizontal_graph'):
            nag = radius_horizontal_graph(
                nag, k_min=graph_k_min, k_max=graph_k_max,
                gap=graph_gap, rng=rng)
    # drop working keys not saved by the reference either
    for k in ('neighbor_index', 'neighbor_distance', 'edge_index',
              'edge_attr', 'node_size', 'grid_size', 'coords'):
        nag[0]._store.pop(k, None)
    if verbose:
        print(t.summary(), flush=True)
    return nag


def quantize_coordinates(data, size=0.1):
    """Integer voxel coordinates `coords` for the sparse CNN (reference
    QuantizePointCoordinates); with the voxel grid's own `size` they are
    unique."""
    data['coords'] = np.floor(
        np.asarray(data.pos) / size).astype(np.int64)
    return data


def greedy_contour_prior_partition(
        data, reg, min_size, spatial_weight=None,
        edge_weight_mode='unit', d_0=None, edge_reduce='add',
        k=0, w_adjacency=0.0, verbose=False):
    """EZ-SP's hierarchical partition by greedy contour-prior merges
    (reference GreedyContourPriorPartition): for each level, edge
    weights from a distance, optionally the weighted positions beside
    the features, then the merge of `ops/components.py` under `reg` and
    that level's `min_size`. Returns a NAG.

    edge_weight_mode: 'unit', or from the distance d of each edge in
    space ('inverse_distance': 1 / (1 + d / d0), 'exp_neg_distance':
    exp(-d / d0)) or between features ('exp_neg_latent_distance'), with
    d0 the mean distance unless `d_0` is given."""
    regs = list(np.atleast_1d(reg).astype(float))
    sizes = list(np.atleast_1d(min_size).astype(int))
    if len(regs) == 1:
        regs = regs * len(sizes)
    if len(regs) != len(sizes):
        raise ValueError(f'greedy_contour_prior_partition: {len(regs)} '
                         f'regularizations for {len(sizes)} levels')

    d1 = data
    if d1.get('node_size') is None:
        d1['node_size'] = np.ones(d1.num_nodes, dtype=np.int64)
    levels = [d1]
    for level, (r, ms) in enumerate(zip(regs, sizes)):
        d1 = levels[level]
        ei = d1.edge_index.astype(np.int64)

        if edge_weight_mode == 'unit':
            w = np.ones(ei.shape[1], np.float32)
        elif edge_weight_mode in ('inverse_distance', 'exp_neg_distance',
                                  'exp_neg_latent_distance'):
            ref = d1.pos if edge_weight_mode != 'exp_neg_latent_distance' \
                else d1.x
            diff = np.asarray(ref)[ei[0]] - np.asarray(ref)[ei[1]]
            dist = np.sqrt((diff * diff).sum(1))
            d0 = float(dist.mean()) if d_0 is None else float(d_0)
            d0 = max(d0, 1e-12)
            if edge_weight_mode == 'inverse_distance':
                w = (1.0 / (1.0 + dist / d0)).astype(np.float32)
            else:
                w = np.exp(-dist / d0).astype(np.float32)
        else:
            raise ValueError(f'unknown edge_weight_mode {edge_weight_mode!r}')

        x = np.asarray(d1.x, np.float32)
        if spatial_weight:
            x = np.concatenate(
                [x, np.asarray(d1.pos, np.float32) * spatial_weight], 1)

        size_arr = np.asarray(d1.node_size, np.float32)
        labels, n_comp, (x_m, s_m, ei_m, w_m, _) = \
            merge_components_by_contour_prior_np(
                x, size_arr, ei, w, r, ms, pos=np.asarray(d1.pos),
                k=k, w_adjacency=w_adjacency, edge_reduce=edge_reduce)
        if verbose:
            print(f'level {level}: {d1.num_nodes} -> {n_comp}')
        d1['super_index'] = labels

        pos_m = np.zeros((n_comp, 3), np.float32)
        np.add.at(pos_m, labels,
                  np.asarray(d1.pos, np.float32) * size_arr[:, None])
        pos_m /= np.maximum(s_m[:, None], 1e-12)

        d2 = Data(
            pos=pos_m,
            x=x_m[:, :np.asarray(d1.x).shape[1]],
            node_size=s_m.astype(np.int64),
            sub=Cluster(labels, np.arange(d1.num_nodes), dense=True),
            edge_index=ei_m,
            edge_attr=w_m.astype(np.float32))
        y = d1.get('y')
        if y is not None:
            if y.ndim != 2:
                raise ValueError('greedy_contour_prior_partition: `y` must '
                                 'be label histograms')
            acc = np.zeros((n_comp, y.shape[1]), dtype=np.int64)
            np.add.at(acc, labels, y)
            d2['y'] = acc
        sp = d1.get('semantic_pred')
        if sp is not None and sp.ndim == 2:
            acc = np.zeros((n_comp, sp.shape[1]), dtype=np.int64)
            np.add.at(acc, labels, sp)
            d2['semantic_pred'] = acc
        if d1.get('obj') is not None and isinstance(d1.obj, InstanceData):
            d2['obj'] = d1.obj.merge(labels)
        levels.append(d2)
    return NAG(levels, start_i_level=0)


def _cnn_state(ckpt_path):
    """The sparse CNN's state_dict from a stage-1 checkpoint of this
    package: a checkpoint directory (`state.pt`, a `torch.save` of
    `PartitionTask.state_dict()`) or the file itself."""
    import torch
    path = osp.join(ckpt_path, 'state.pt') if osp.isdir(ckpt_path) \
        else ckpt_path
    state = torch.load(path, map_location='cpu', weights_only=True)
    return state.get('model', state)


def pretrained_cnn_features(data, ckpt_path=None, params=None,
                            channels=(32, 32, 32), voxel=0.1,
                            key='x', out_key='x', device='cuda'):
    """EZ-SP stage 2: the frozen stage-1 sparse CNN's embeddings of
    `data[key]` as `data[out_key]` (f32), so that the partition sees
    learned features (reference PretrainedCNN).

    The weights come from `params` (a `state_dict` of a `PartitionModel`,
    `cnn.*` keys, or of its `SparseCNN`) or from the checkpoint at
    `ckpt_path` that `fit_partition` writes (`torch.save`, `state.pt`);
    `channels` are the blocks' widths and must match them. The CNN runs
    on `device`: the card unless the caller asks for the CPU; without a
    card it raises."""
    import torch
    from ..nn.sparse import SparseCNN
    from ..ops.voxel_conv import build_sparse_conv_neighbors

    device = torch.device(device)
    if device.type == 'cuda' and not torch.cuda.is_available():
        raise RuntimeError('pretrained_cnn_features: no CUDA device; pass '
                           'device="cpu" to run the CNN on the CPU')
    if params is None:
        if ckpt_path is None:
            raise ValueError('pretrained_cnn_features: give ckpt_path or '
                             'params')
        params = _cnn_state(ckpt_path)
    state = {k[len('cnn.'):] if k.startswith('cnn.') else k: v
             for k, v in params.items()}

    if data.get('coords') is None:
        data = quantize_coordinates(data, size=voxel)
    nbr = build_sparse_conv_neighbors(data.coords)
    x = np.asarray(data[key], np.float32)
    model = SparseCNN(x.shape[1], channels, num_graphs=1, device=device)
    model.load_state_dict({k: torch.as_tensor(v) for k, v in state.items()})
    model.eval()
    with torch.no_grad():
        emb = model(torch.from_numpy(x).to(device),
                    torch.from_numpy(nbr).long().to(device),
                    batch=torch.zeros(x.shape[0], dtype=torch.long,
                                      device=device))
    data[out_key] = emb.cpu().numpy().astype(np.float32)
    return data


def sample_xy_tiling(data, tiling=(2, 2), tile=(0, 0)):
    """Select one tile of a regular XY grid over the cloud's bounding
    box (the JAX `sample_xy_tiling`; huge clouds are split so at
    preprocessing)."""
    pos = np.asarray(data.pos)
    tx, ty = (tiling, tiling) if np.isscalar(tiling) else tiling
    pos2 = pos[:, :2].astype(np.float64)
    lo = pos2.min(0)
    hi = pos2.max(0)
    span = np.maximum(hi - lo, 1e-9)
    # clip after the int cast: rounding can put the max point at tx
    ix = np.clip(((pos2[:, 0] - lo[0]) / span[0] * tx).astype(int),
                 0, tx - 1)
    iy = np.clip(((pos2[:, 1] - lo[1]) / span[1] * ty).astype(int),
                 0, ty - 1)
    keep = (ix == tile[0]) & (iy == tile[1])
    out, _ = data.select(np.where(keep)[0])
    return out


def sample_recursive_main_xy_axis_tiling(data, steps=1, tile=0):
    """Split the cloud in half along its principal XY direction (PCA),
    `steps` times, and return tile `tile` in [0, 2**steps) (the JAX
    `sample_recursive_main_xy_axis_tiling`)."""
    out = data
    for s in range(steps):
        pos = np.asarray(out.pos)[:, :2]
        c = pos - pos.mean(0)
        cov = c.T @ c / max(pos.shape[0] - 1, 1)
        _, v = np.linalg.eigh(cov)
        proj = c @ v[:, -1]
        half = (tile >> (steps - 1 - s)) & 1
        med = np.median(proj)
        keep = proj >= med if half else proj < med
        out, _ = out.select(np.where(keep)[0])
    return out


def grid_partition(data, sizes=(2.0, 10.0), mode='xy'):
    """Hierarchical partition by regular grids of growing size
    (reference GridPartition, src/transforms/partition.py:316: xy or xyz
    cells instead of cut pursuit, for quick baselines and very large
    aerial tiles). Cells that hold level-0 KNN edges between them are
    joined by a level edge weighted by their count. Returns a NAG."""
    d1 = data
    if d1.get('node_size') is None:
        d1['node_size'] = np.ones(d1.num_nodes, dtype=np.int64)
    levels = [d1]
    dims = 2 if mode == 'xy' else 3
    for size in np.atleast_1d(sizes).astype(float):
        d1 = levels[-1]
        pos = np.asarray(d1.pos)
        cells = np.floor(pos[:, :dims] / size).astype(np.int64)
        cells -= cells.min(0)
        span = cells.max(0) + 1
        key = cells[:, 0]
        for j in range(1, dims):
            key = key * span[j] + cells[:, j]
        _, super_index = np.unique(key, return_inverse=True)
        n_comp = int(super_index.max()) + 1 if super_index.size else 0
        d1['super_index'] = super_index

        size_arr = np.asarray(d1.node_size, np.float64)
        s_m = np.zeros(n_comp)
        np.add.at(s_m, super_index, size_arr)
        pos_m = np.zeros((n_comp, 3))
        np.add.at(pos_m, super_index, pos * size_arr[:, None])
        pos_m /= np.maximum(s_m[:, None], 1e-12)

        d2 = Data(pos=pos_m.astype(np.float32),
                  node_size=s_m.astype(np.int64),
                  sub=Cluster(super_index, np.arange(d1.num_nodes),
                              dense=True))
        x = d1.get('x')
        if x is not None:
            x_m = np.zeros((n_comp, x.shape[1]))
            np.add.at(x_m, super_index,
                      np.asarray(x, np.float64) * size_arr[:, None])
            d2['x'] = (x_m / np.maximum(s_m[:, None], 1e-12)).astype(
                np.float32)
        y = d1.get('y')
        if y is not None and y.ndim == 2:
            acc = np.zeros((n_comp, y.shape[1]), dtype=np.int64)
            np.add.at(acc, super_index, y)
            d2['y'] = acc
        ei = d1.get('edge_index')
        if ei is not None and ei.size:
            cs, ct = super_index[ei[0]], super_index[ei[1]]
            cross = cs != ct
            if cross.any():
                red, w = to_trimmed_np(
                    np.stack([cs[cross], ct[cross]]),
                    np.ones((int(cross.sum()), 1), np.float32),
                    reduce='sum')
                d2['edge_index'] = red
                d2['edge_attr'] = w.reshape(-1)
        levels.append(d2)
    return NAG(levels, start_i_level=0)
