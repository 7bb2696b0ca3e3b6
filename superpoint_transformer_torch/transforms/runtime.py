"""Runtime (per-batch) transforms on the host (numpy): a copy of the
functions of the JAX package's `transforms/runtime.py`, with the same
arguments and the same numpy random draws. NodeSize, on-the-fly
horizontal and vertical edge features, self loops, geometric
augmentations and subgraph sampling, after the reference's on-device
train/val transforms (configs/datamodule/semantic/default.yaml:206-428),
which `transforms.prepare.process_batch` calls; and the reference's
other NAG transforms: k-hop crops, neighbor-based cleanup, feature
dropout, shuffling and key or column selection.
"""
import numpy as np

from ..ops.graph import add_self_loops_np
from ..ops.native import radius_knn

__all__ = [
    'node_size', 'on_the_fly_horizontal_edge_features',
    'on_the_fly_vertical_edge_features', 'add_self_loops',
    'jitter_key', 'random_tilt_and_rotate', 'random_anisotropic_scale',
    'random_axis_flip', 'sample_sub_nodes', 'sample_radius_subgraphs',
    'sample_segments', 'sample_edges', 'restrict_size',
    'sample_khop_subgraphs', 'outliers', 'inliers', 'dropout_columns',
    'dropout_rows', 'shuffle', 'select_by_key', 'select_columns',
]

H_EDGE_KEYS_DEFAULT = (
    'mean_off', 'std_off', 'mean_dist', 'angle_source', 'angle_target',
    'centroid_dir', 'centroid_dist', 'normal_angle', 'log_length',
    'log_surface', 'log_volume', 'log_size')

V_EDGE_KEYS_DEFAULT = (
    'centroid_dir', 'centroid_dist', 'normal_angle', 'log_length',
    'log_surface', 'log_volume', 'log_size')


def node_size(nag, low=0):
    """Per-node count of `low`-level elements (reference NodeSize,
    src/transforms/graph.py:1475)."""
    for i in range(max(low + 1, nag.start_i_level + 1),
                   nag.absolute_num_levels):
        nag[i]['node_size'] = nag.get_sub_size(i, low=low).astype(
            np.float32)
    # level `low` itself: unit sizes (used by UnitSphereNorm weights)
    if nag.start_i_level <= low:
        nag[low]['node_size'] = np.ones(nag[low].num_nodes,
                                        dtype=np.float32)
    return nag


def on_the_fly_horizontal_edge_features(
        nag, keys=H_EDGE_KEYS_DEFAULT, use_mean_normal=False):
    """Untrim the i<j horizontal graph to bidirectional and build the
    full edge feature set. Feature ORDER matches the reference
    concatenation order exactly (src/transforms/graph.py:1188-1270):
    [mean_off, std_off, mean_dist, angle_source, angle_target,
     normal_angle, log_length, log_surface, log_volume, log_size,
     centroid_dir, centroid_dist].
    """
    normal_key = 'mean_normal' if use_mean_normal else 'normal'
    for i in nag.levels:
        if i == 0:
            continue
        d = nag[i]
        if 'edge_index' not in d or d.num_edges == 0:
            continue
        se = d.edge_index.astype(np.int64)
        ea = d.get('edge_attr')
        f_list = []

        if 'std_off' in keys:
            f = ea[:, 3:6].astype(np.float32)
            f_list.append(np.concatenate([f, f], 0))
        if 'mean_dist' in keys:
            f = ea[:, 6].astype(np.float32).reshape(-1, 1)
            f_list.append(np.concatenate([f, f], 0))
        if 'mean_off' in keys or 'angle_source' in keys \
                or 'angle_target' in keys:
            mean_off = ea[:, :3].astype(np.float32)
            nrm = np.linalg.norm(mean_off, axis=1, keepdims=True)
            direction = np.divide(
                mean_off, nrm, out=np.zeros_like(mean_off), where=nrm > 0)
            direction = np.clip(direction, -1, 1)
            if 'mean_off' in keys:
                f_list = [np.concatenate([mean_off, -mean_off], 0)] + f_list
            if 'angle_source' in keys:
                normal = d.get(normal_key)
                f = np.abs((direction * normal[se[0]]).sum(1))
                f_list.append(np.concatenate([f, f]).reshape(-1, 1))
            if 'angle_target' in keys:
                normal = d.get(normal_key)
                f = np.abs((direction * normal[se[1]]).sum(1))
                f_list.append(np.concatenate([f, f]).reshape(-1, 1))
        if 'normal_angle' in keys:
            normal = d.get(normal_key)
            f = np.abs((normal[se[0]] * normal[se[1]]).sum(1))
            f_list.append(np.concatenate([f, f]).reshape(-1, 1))
        for k in ('log_length', 'log_surface', 'log_volume', 'log_size'):
            if k in keys:
                v = d.get(k).reshape(-1, 1).astype(np.float32)
                f = v[se[0]] - v[se[1]]
                f_list.append(np.concatenate([f, -f], 0))
        if 'centroid_dir' in keys or 'centroid_dist' in keys:
            cdir = (d.pos[se[1]] - d.pos[se[0]]).astype(np.float32)
            cdist = np.linalg.norm(cdir, axis=1, keepdims=True)
            cdir = np.divide(cdir, cdist, out=np.zeros_like(cdir),
                             where=cdist > 0)
            cdir = np.clip(cdir, -1, 1)
            cdist = np.sqrt(cdist)
            if 'centroid_dir' in keys:
                f_list.append(np.concatenate([cdir, -cdir], 0))
            if 'centroid_dist' in keys:
                f_list.append(np.concatenate([cdist, cdist], 0))

        d['edge_index'] = np.concatenate([se, se[::-1]], 1)
        if f_list:
            d['edge_attr'] = np.concatenate(f_list, 1).astype(np.float32)
        else:
            d._store.pop('edge_attr', None)
    return nag


def on_the_fly_vertical_edge_features(
        nag, keys=V_EDGE_KEYS_DEFAULT, use_mean_normal=False):
    """Child->parent edge features, stored on the CHILD level as
    `v_edge_attr` (reference src/transforms/graph.py:1337)."""
    if not keys:
        return nag
    normal_key = 'mean_normal' if use_mean_normal else 'normal'
    for i in range(nag.start_i_level + 1, nag.absolute_num_levels):
        child, parent = nag[i - 1], nag[i]
        idx = child.super_index.astype(np.int64)
        f_list = []
        if 'centroid_dir' in keys or 'centroid_dist' in keys:
            cdir = (parent.pos[idx] - child.pos).astype(np.float32)
            cdist = np.linalg.norm(cdir, axis=1, keepdims=True)
            cdir = np.divide(cdir, cdist, out=np.zeros_like(cdir),
                             where=cdist > 0)
            cdir = np.clip(cdir, -1, 1)
            if 'centroid_dir' in keys:
                f_list.append(cdir)
            if 'centroid_dist' in keys:
                f_list.append(np.sqrt(cdist))
        if 'normal_angle' in keys:
            cn = child.get(normal_key)
            pn = parent.get(normal_key)
            f = np.abs((cn * pn[idx]).sum(1)).reshape(-1, 1)
            f_list.append(f)
        for k in ('log_length', 'log_surface', 'log_volume', 'log_size'):
            if k in keys:
                f = (parent.get(k).reshape(-1, 1)[idx]
                     - child.get(k).reshape(-1, 1))
                f_list.append(f.astype(np.float32))
        if f_list:
            child['v_edge_attr'] = np.concatenate(f_list, 1)
    return nag


def add_self_loops(nag):
    """Add i->i edges with zero edge_attr to every level with a
    horizontal graph (reference NAGAddSelfLoops,
    src/transforms/graph.py:1419)."""
    for i in nag.levels:
        d = nag[i]
        if 'edge_index' not in d:
            continue
        ei, ea = add_self_loops_np(
            d.edge_index.astype(np.int64), d.get('edge_attr'),
            d.num_nodes)
        d['edge_index'] = ei
        if ea is not None:
            d['edge_attr'] = ea
    return nag


# --------------------------------------------------------------------------
# Geometric augmentations (reference src/transforms/geometry.py)
# --------------------------------------------------------------------------

def jitter_key(nag, rng, key='pos', sigma=0.03, trunc=0.06, level='all'):
    if sigma <= 0:
        return nag
    for i in nag._parse_levels(level):
        d = nag[i]
        v = d.get(key)
        if v is None:
            continue
        noise = rng.standard_normal(v.shape, dtype=np.float32)
        noise *= sigma
        np.clip(noise, -trunc, trunc, out=noise)
        noise += v
        d[key] = noise
    return nag


def random_tilt_and_rotate(nag, rng, phi=0.1, theta=180):
    """Random rotation around z (theta, degrees) + tilt (phi) applied
    to pos, normal and oriented edge features of all levels (reference
    RandomTiltAndRotate, src/transforms/geometry.py:28)."""
    if phi <= 0 and theta <= 0:
        return nag
    t = np.radians(rng.uniform(-theta, theta))
    p = np.radians(rng.uniform(-phi, phi))
    axis = rng.integers(0, 2)  # tilt around x or y
    cz, sz = np.cos(t), np.sin(t)
    Rz = np.array([[cz, -sz, 0], [sz, cz, 0], [0, 0, 1]], dtype=np.float32)
    cp, sp = np.cos(p), np.sin(p)
    if axis == 0:
        Rt = np.array([[1, 0, 0], [0, cp, -sp], [0, sp, cp]],
                      dtype=np.float32)
    else:
        Rt = np.array([[cp, 0, sp], [0, 1, 0], [-sp, 0, cp]],
                      dtype=np.float32)
    R = (Rt @ Rz).astype(np.float32)
    _apply_linear(nag, R)
    return nag


def random_anisotropic_scale(nag, rng, delta=0.2):
    if delta <= 0:
        return nag
    s = rng.uniform(1 - delta, 1 + delta, 3).astype(np.float32)
    _apply_linear(nag, np.diag(s), renormalize_normals=True)
    return nag


def random_axis_flip(nag, rng, p=0.5, axis=None):
    ax = int(rng.integers(0, 2)) if axis is None else axis
    if rng.uniform() > p:
        return nag
    S = np.eye(3, dtype=np.float32)
    S[ax, ax] = -1
    _apply_linear(nag, S)
    return nag


def _apply_linear(nag, M, renormalize_normals=False):
    """Apply a 3x3 linear map to every oriented attribute of the NAG."""
    for i in nag.levels:
        d = nag[i]
        for k in ('pos', 'normal', 'mean_normal'):
            v = d.get(k)
            if v is not None:
                v = (v @ M.T).astype(np.float32)
                if renormalize_normals and k in ('normal', 'mean_normal'):
                    n = np.linalg.norm(v, axis=1, keepdims=True)
                    v = np.divide(v, n, out=v, where=n > 0)
                d[k] = v
        ea = d.get('edge_attr')
        if ea is not None and ea.shape[1] >= 3:
            # stored 7-dim minimalistic features: mean_off | std_off |
            # mean_dist — rotate offsets
            ea = ea.copy().astype(np.float32)
            ea[:, :3] = ea[:, :3] @ M.T
            if ea.shape[1] >= 6:
                ea[:, 3:6] = np.abs(ea[:, 3:6] @ M.T)
            d['edge_attr'] = ea
    return nag


# --------------------------------------------------------------------------
# Sampling (reference src/transforms/sampling.py)
# --------------------------------------------------------------------------

def sample_sub_nodes(nag, rng, low=0, high=1, n_min=32, n_max=128):
    """Randomly keep n_min..n_max level-`low` points per level-`high`
    segment (reference SampleSubNodes, src/transforms/sampling.py:656)."""
    if high <= low:
        return nag
    d = nag[low]
    sup = nag.get_super_index(high, low=low)
    num_seg = nag[high].num_nodes
    order = np.argsort(sup, kind='stable')
    counts = np.bincount(sup, minlength=num_seg)
    starts = np.zeros(num_seg + 1, dtype=np.int64)
    np.cumsum(counts, out=starts[1:])
    # per-segment budget: keep between n_min and n_max points, but
    # never more than the segment actually has
    budget_of = np.clip(counts, n_min, n_max)
    budget_of = np.minimum(budget_of, counts)
    # sample without replacement per segment: rank elements within
    # their segment by a random key, keep ranks below the budget
    r = rng.random(sup.shape[0])
    seg_sorted = np.lexsort((r, sup))
    rank = np.empty(sup.shape[0], dtype=np.int64)
    rank[seg_sorted] = np.arange(sup.shape[0]) - starts[sup[seg_sorted]]
    keep = rank < budget_of[sup]
    idx = np.where(keep)[0]
    return nag.select(low, idx)


def sample_radius_subgraphs(nag, rng, r=7.0, k=4, i_level=1,
                            cylindrical=False, disjoint=True, k_max=None):
    """Spherical/cylindrical crops around k random seed segments at
    `i_level` — THE train-batch construction (reference
    SampleRadiusSubgraphs, src/transforms/sampling.py:1094)."""
    if r <= 0 or k <= 0:
        return nag
    d = nag[i_level]
    n = d.num_nodes
    if n == 0:
        return nag
    seeds = rng.integers(0, n, min(k, n))
    pos = d.pos
    keep_mask = np.zeros(n, dtype=bool)
    for s in seeds:
        delta = pos - pos[s]
        if cylindrical:
            dist = np.linalg.norm(delta[:, :2], axis=1)
        else:
            dist = np.linalg.norm(delta, axis=1)
        keep_mask |= dist < r
    idx = np.where(keep_mask)[0]
    if k_max is not None and idx.shape[0] > k_max:
        idx = rng.choice(idx, k_max, replace=False)
        idx.sort()
    return nag.select(i_level, idx)


def sample_segments(nag, rng, ratio=0.1, by_size=True, by_class=False):
    """Randomly drop a ratio of level-1 segments (reference
    SampleSegments, src/transforms/sampling.py:718). `by_size` weights
    the keep probability by segment size."""
    if ratio <= 0:
        return nag
    d = nag[1]
    n = d.num_nodes
    n_drop = int(n * ratio)
    if n_drop == 0 or n <= 1:
        return nag
    if by_size and 'node_size' in d:
        w = d.node_size.reshape(-1).astype(np.float64)
        w = w / w.sum()
        drop = rng.choice(n, n_drop, replace=False, p=w)
    else:
        drop = rng.choice(n, n_drop, replace=False)
    keep = np.setdiff1d(np.arange(n), drop)
    return nag.select(1, keep)


def sample_edges(nag, rng, level='1+', n_min=-1, n_max=-1):
    """Cap the number of outgoing edges per node (reference
    SampleEdges, src/transforms/sampling.py:1234)."""
    if n_max is None or (np.isscalar(n_max) and n_max < 0):
        return nag
    for i in nag._parse_levels(level):
        d = nag[i]
        if 'edge_index' not in d:
            continue
        src = d.edge_index[0]
        r = rng.random(src.shape[0])
        order = np.lexsort((r, src))
        counts = np.bincount(src, minlength=d.num_nodes)
        starts = np.zeros(d.num_nodes + 1, dtype=np.int64)
        np.cumsum(counts, out=starts[1:])
        rank = np.empty(src.shape[0], dtype=np.int64)
        rank[order] = np.arange(src.shape[0]) - starts[src[order]]
        keep = rank < n_max
        d['edge_index'] = d.edge_index[:, keep]
        if 'edge_attr' in d:
            d['edge_attr'] = d.edge_attr[keep]
    return nag


def restrict_size(nag, rng, level='1+', num_nodes=0, num_edges=0):
    """Hard node/edge caps (reference NAGRestrictSize,
    src/transforms/sampling.py:1351)."""
    if num_nodes and num_nodes > 0:
        for i in nag._parse_levels(level):
            if nag[i].num_nodes > num_nodes:
                idx = rng.choice(nag[i].num_nodes, num_nodes,
                                 replace=False)
                idx.sort()
                nag = nag.select(i, idx)
    if num_edges and num_edges > 0:
        for i in nag._parse_levels(level):
            d = nag[i]
            if d.num_edges > num_edges:
                keep = rng.choice(d.num_edges, num_edges, replace=False)
                keep.sort()
                d['edge_index'] = d.edge_index[:, keep]
                if 'edge_attr' in d:
                    d['edge_attr'] = d.edge_attr[keep]
    return nag


def sample_khop_subgraphs(nag, rng, k_hop=2, n_seeds=4, i_level=1):
    """Crop the NAG to the k-hop neighborhoods of random seed segments on
    the level-`i_level` horizontal graph (reference SampleKHopSubgraphs,
    src/transforms/sampling.py:1003; an alternative to the radius crops
    of `sample_radius_subgraphs`)."""
    d = nag[i_level]
    n = d.num_nodes
    if n == 0 or d.get('edge_index') is None:
        return nag
    seeds = rng.choice(n, size=min(n_seeds, n), replace=False)
    keep = np.zeros(n, bool)
    keep[seeds] = True
    ei = d.edge_index
    for _ in range(k_hop):
        grow = keep.copy()
        m = keep[ei[0]]
        grow[ei[1][m]] = True
        m = keep[ei[1]]
        grow[ei[0][m]] = True
        keep = grow
    return _select_level_cascade(nag, i_level, np.where(keep)[0])


def _select_level_cascade(nag, i_level, idx):
    """Select level-i nodes and cascade the selection through all levels
    (reference NAG.select, src/data/nag.py:306)."""
    return nag.select(i_level, idx)


def outliers(nag, k_min=1, level=0):
    """Drop the nodes with fewer than `k_min` valid entries in their
    stored `neighbor_index` row (reference Outliers,
    src/transforms/neighbors.py:167). Without a `neighbor_index` the NAG
    is returned as it is."""
    d = nag[level]
    ni = d.get('neighbor_index')
    if ni is None:
        return nag
    deg = (np.asarray(ni) >= 0).sum(1)
    keep = np.where(deg >= k_min)[0]
    if keep.shape[0] == d.num_nodes:
        return nag
    return nag.select(level, keep)


def inliers(nag, k_min, r_max=1.0, level=0, recursive=False):
    """Keep only the nodes with `k_min` or more neighbors within `r_max`
    (reference Inliers, src/transforms/neighbors.py:137), from a radius
    search of its own (the native `radius_knn`), whatever
    `neighbor_index` holds. `recursive=True` searches again after each
    removal, since removing nodes can leave their neighbors short, until
    every kept node has `k_min` neighbors."""
    d = nag[level]
    pos = np.asarray(d.pos, np.float32)
    keep = np.arange(pos.shape[0])
    while True:
        nbr, _ = radius_knn(pos[keep], r=float(r_max),
                            k=int(k_min) + 1, exclude_self=True)
        deg = (nbr >= 0).sum(1)
        ok = deg >= k_min
        if ok.all():
            break
        keep = keep[ok]
        if not recursive:
            break
    if keep.shape[0] == d.num_nodes:
        return nag
    return nag.select(level, keep)


def dropout_columns(nag, rng, key='x', p=0.1, level='all'):
    """Zero whole columns of the 2-D attribute `key`, each with
    probability `p` (reference DropoutColumns, src/transforms/data.py)."""
    for i in nag._parse_levels(level):
        d = nag[i]
        v = d.get(key)
        if v is None or v.ndim != 2:
            continue
        mask = rng.random(v.shape[1]) >= p
        d[key] = (np.asarray(v) * mask[None, :]).astype(np.float32)
    return nag


def dropout_rows(nag, rng, key='x', p=0.1, level='all'):
    """Zero whole rows of the 2-D attribute `key`, each with probability
    `p` (reference DropoutRows, src/transforms/data.py)."""
    for i in nag._parse_levels(level):
        d = nag[i]
        v = d.get(key)
        if v is None or v.ndim != 2:
            continue
        mask = rng.random(v.shape[0]) >= p
        d[key] = (np.asarray(v) * mask[:, None]).astype(np.float32)
    return nag


def shuffle(nag, rng, level=0):
    """A random permutation of the level's nodes (reference Shuffle,
    src/transforms/sampling.py:48)."""
    n = nag[level].num_nodes
    return nag.select(level, rng.permutation(n))


def select_by_key(nag, key, level=0, negation=False, strict=True,
                  delete_after=True):
    """Keep the level's nodes whose boolean attribute `key` is True, or
    False with `negation` (reference NAGSelectByKey,
    src/transforms/data.py:302). A missing key, or one that is not a bool
    vector over the nodes, raises ValueError when `strict`, else leaves
    the NAG as it is. `delete_after` drops the key from the result."""
    d = nag[level]
    mask = d.get(key)
    if mask is None:
        if strict:
            raise ValueError(f'no `{key}` attribute at level {level}')
        return nag
    mask = np.asarray(mask)
    if mask.dtype != bool:
        if strict:
            raise ValueError(f'`{key}` has dtype {mask.dtype}, '
                             'expected bool')
        return nag
    if mask.shape != (d.num_nodes,):
        if strict:
            raise ValueError(f'`{key}` has shape {mask.shape}, '
                             f'expected ({d.num_nodes},)')
        return nag
    if negation:
        mask = ~mask
    nag = nag.select(level, np.where(mask)[0])
    if delete_after:
        setattr(nag[level], key, None)
    return nag


def select_columns(nag, key, idx, level='all'):
    """Keep only the columns `idx` of the 2-D attribute `key` (reference
    SelectColumns / NAGSelectColumns, src/transforms/data.py:379)."""
    if idx is None:
        return nag
    idx = np.atleast_1d(np.asarray(idx, dtype=np.int64))
    for i in nag._parse_levels(level):
        d = nag[i]
        v = d.get(key)
        if v is None or v.ndim != 2:
            continue
        d[key] = v[:, idx]
    return nag
