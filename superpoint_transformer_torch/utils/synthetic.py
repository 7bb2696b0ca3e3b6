"""Synthetic data, numpy only: padded NAG batches
(`random_padded_nag`), and copies of the JAX package's `random_nag`
(a small 3-level NAG) and `synthetic_room_cloud` (a raw indoor cloud
for the preprocessing path).

`random_padded_nag` builds directly the padded batch that the JAX host
path (`prepare_batch(..., device=False)`, i.e. `pad_nag` with the S3DIS
feature layout) would produce for a 3-level NAG, without needing jax,
flax or h5py. It keeps every invariant of `pad_nag`, the transpose
neighbor tables of levels 1 and 2 included:

- each level is sorted by `super_index`, and graphs are contiguous;
- padded rows have `batch == -1`, and padded children have
  `super_index == parent capacity`;
- padded neighbor slots point at node 0 with the mask False, and K is a
  multiple of 16;
- every node has a self-loop (slot 0, zero edge features);
- level-0 `x` is 8 wide (5 geometric features + rgb), `edge_feat` is 18
  wide, and levels 1+ have no `x`;
- level-1 `node_id` is a permutation; invalid edge slots hold finite
  values.
"""
import numpy as np

from ..data.csr import Cluster, InstanceData
from ..data.data import Data
from ..data.nag import NAG
from ..data.pad import bucket, transpose_neighbors
from ..data.padded import PaddedLevel, PaddedNAG
from ..ops.graph import _round_up

__all__ = ['random_padded_nag', 'random_nag', 'synthetic_room_cloud',
           'POINT_HF_DIM', 'EDGE_HF_DIM']

POINT_HF_DIM = 8    # linearity, planarity, scattering, verticality,
                    # elevation, rgb
EDGE_HF_DIM = 18    # the default horizontal edge features


def _sizes(rng, n, num_graphs):
    """Per-graph node counts around `n` (+-10%), at least 1."""
    return np.maximum(
        (n * rng.uniform(0.9, 1.1, num_graphs)).astype(np.int64), 1)


def _children(rng, child_sizes, parent_sizes):
    """Sorted parent index of every child, each parent of a graph
    receiving at least one child of the same graph."""
    off = np.concatenate([[0], np.cumsum(parent_sizes)[:-1]])
    sup = []
    for c, p, o in zip(child_sizes, parent_sizes, off):
        s = np.concatenate([np.arange(p), rng.integers(0, p, c - p)])
        sup.append(np.sort(s) + o)
    return np.concatenate(sup)


def _pad(a, cap, fill=0):
    out = np.full((cap,) + a.shape[1:], fill, dtype=a.dtype)
    out[:a.shape[0]] = a
    return out


def _neighbors(rng, batch, sizes, deg_range, cap):
    """Dense neighbor table: slot 0 is the self-loop, the other valid
    slots point at random nodes of the same graph."""
    n = batch.shape[0]
    start = np.concatenate([[0], np.cumsum(sizes)[:-1]])
    deg = rng.integers(deg_range[0], deg_range[1] + 1, n)
    deg = np.minimum(deg, sizes[batch])
    K = max(_round_up(int(deg.max()), 16), 16)
    idx = start[batch][:, None] + (
        rng.random((n, K)) * sizes[batch][:, None]).astype(np.int64)
    idx[:, 0] = np.arange(n)
    mask = np.arange(K)[None, :] < deg[:, None]
    idx = np.where(mask, idx, 0)
    ef = rng.standard_normal((cap, K, EDGE_HF_DIM)).astype(np.float32)
    ef[np.arange(n), 0] = 0.0      # self-loops carry zero features
    return (_pad(idx.astype(np.int32), cap), _pad(mask, cap, False), ef)


def _histogram(rng, sizes, num_classes):
    n = sizes.shape[0]
    y = np.zeros((n, num_classes + 1), dtype=np.float32)
    y[np.arange(n), rng.integers(0, num_classes, n)] = sizes
    return y


def random_padded_nag(seed=0, num_graphs=2, n_points=2048, n_l1=128,
                      n_l2=32, degree=(4, 40), num_classes=13,
                      node_caps=None):
    """A padded 3-level batch of `num_graphs` graphs, each with about
    `n_points` level-0 points, `n_l1` level-1 and `n_l2` level-2 nodes
    (+-10% per graph), and a valid-neighbor count (self-loop included)
    drawn from `degree` at levels 1 and 2. `node_caps` (level ->
    capacity, as `pad_nag`'s) overrides the bucketed capacities; the
    node counts do not depend on it. Returns a `PaddedNAG` with
    numpy leaves, the layout of the JAX host path's output; convert it
    with `data.padded.from_numpy`."""
    rng = np.random.default_rng(seed)
    G = num_graphs
    s2 = _sizes(rng, n_l2, G)
    s1 = np.maximum(_sizes(rng, n_l1, G), s2)
    s0 = np.maximum(_sizes(rng, n_points, G), s1)
    b2 = np.repeat(np.arange(G), s2)
    sup1 = _children(rng, s1, s2)
    sup0 = _children(rng, s0, s1)
    b1, b0 = b2[sup1], b2[sup1][sup0]
    n0, n1, n2 = len(b0), len(b1), len(b2)
    cap0, cap1, cap2 = ((node_caps or {}).get(i) or bucket(n)
                        for i, n in enumerate((n0, n1, n2)))

    # room-scale positions: children scattered around their parents
    c2 = (rng.random((n2, 3)) * [10.0, 8.0, 3.0]).astype(np.float32)
    c1 = c2[sup1] + rng.normal(0, 1.0, (n1, 3)).astype(np.float32)
    pos0 = c1[sup0] + rng.normal(0, 0.2, (n0, 3)).astype(np.float32)

    def mean_pos(pos, sup, n):
        cnt = np.bincount(sup, minlength=n).astype(np.float32)
        out = np.stack([np.bincount(sup, pos[:, i], minlength=n)
                        for i in range(3)], 1)
        return (out / cnt[:, None]).astype(np.float32)

    pos1 = mean_pos(pos0, sup0, n1)
    pos2 = mean_pos(pos1, sup1, n2)
    size1 = np.bincount(sup0, minlength=n1).astype(np.float32)
    size2 = np.bincount(sup1, weights=size1, minlength=n2).astype(
        np.float32)

    def level(pos, batch, cap, node_size, y, **kw):
        n = pos.shape[0]
        return PaddedLevel(
            pos=_pad(pos, cap), node_mask=_pad(np.ones(n, bool), cap, False),
            batch=_pad(batch.astype(np.int32), cap, -1),
            num_nodes=np.int32(n), node_size=_pad(node_size, cap),
            y=_pad(y, cap), **kw)

    nbr1, m1, ef1 = _neighbors(rng, b1, s1, degree, cap1)
    nbr2, m2, ef2 = _neighbors(rng, b2, s2, degree, cap2)
    l0 = level(pos0, b0, cap0, np.ones(n0, np.float32),
               _histogram(rng, np.ones(n0, np.float32), num_classes),
               x=_pad(rng.random((n0, POINT_HF_DIM)).astype(np.float32),
                      cap0),
               super_index=_pad(sup0.astype(np.int32), cap0, cap1))
    in1, im1 = transpose_neighbors(nbr1, m1)
    in2, im2 = transpose_neighbors(nbr2, m2)
    l1 = level(pos1, b1, cap1, size1, _histogram(rng, size1, num_classes),
               super_index=_pad(sup1.astype(np.int32), cap1, cap2),
               nbr_idx=nbr1, nbr_mask=m1, edge_feat=ef1,
               nbr_in_idx=in1, nbr_in_mask=im1,
               node_id=_pad(rng.permutation(n1).astype(np.int32), cap1,
                            -1))
    l2 = level(pos2, b2, cap2, size2, _histogram(rng, size2, num_classes),
               nbr_idx=nbr2, nbr_mask=m2, edge_feat=ef2, nbr_in_idx=in2,
               nbr_in_mask=im2)
    return PaddedNAG(levels=(l0, l1, l2), start_i_level=0, num_graphs=G)


def random_nag(seed=0, n_points=512, n_l1=64, n_l2=16, num_classes=13,
               k_edges=6, with_features=True, with_instances=False):
    """A small, structurally-valid 3-level NAG with the S3DIS feature
    layout (8 point features, 7-dim stored edge features, histogram
    labels), with the numpy draws of the JAX `random_nag`;
    `with_instances` adds level-1 `obj` InstanceData."""
    rng = np.random.default_rng(seed)
    sup0 = rng.integers(0, n_l1, n_points)
    sup0[:n_l1] = np.arange(n_l1)
    sup1 = rng.integers(0, n_l2, n_l1)
    sup1[:n_l2] = np.arange(n_l2)

    pos0 = rng.normal(size=(n_points, 3)).astype(np.float32) * 5

    def seg_pos(pos, sup, n):
        out = np.zeros((n, 3), dtype=np.float32)
        cnt = np.bincount(sup, minlength=n)[:, None].astype(np.float32)
        np.add.at(out, sup, pos)
        return out / np.maximum(cnt, 1)

    pos1 = seg_pos(pos0, sup0, n_l1)
    pos2 = seg_pos(pos1, sup1, n_l2)

    def edges(n, k):
        s = np.repeat(np.arange(n), k)
        t = rng.integers(0, n, n * k)
        keep = s < t
        return np.stack([s[keep], t[keep]])

    def hist(n, counts):
        h = np.zeros((n, num_classes + 1), dtype=np.int64)
        labels = rng.integers(0, num_classes, n)
        h[np.arange(n), labels] = counts
        return h

    d0 = Data(pos=pos0, super_index=sup0,
              y=rng.integers(0, num_classes, n_points))
    if with_features:
        for k in ('linearity', 'planarity', 'scattering', 'verticality',
                  'elevation'):
            d0[k] = rng.random((n_points, 1)).astype(np.float32)
        d0['rgb'] = rng.random((n_points, 3)).astype(np.float32)

    ei1 = edges(n_l1, k_edges)
    ei2 = edges(n_l2, max(2, k_edges // 2))
    d1 = Data(pos=pos1, super_index=sup1,
              sub=Cluster(sup0, np.arange(n_points), dense=True),
              edge_index=ei1,
              edge_attr=rng.normal(size=(ei1.shape[1], 7)).astype(
                  np.float32),
              y=hist(n_l1, rng.integers(1, 50, n_l1)),
              normal=_unit(rng, n_l1),
              log_length=rng.random((n_l1, 1)).astype(np.float32),
              log_surface=rng.random((n_l1, 1)).astype(np.float32),
              log_volume=rng.random((n_l1, 1)).astype(np.float32),
              log_size=rng.random((n_l1, 1)).astype(np.float32))
    if with_instances:
        # each level-1 segment overlaps its own dominant gt object
        # (id = segment // 2, so pairs of segments share an object)
        obj_of_seg = np.arange(n_l1) // 2
        y_of_obj = rng.integers(0, num_classes, obj_of_seg.max() + 1)
        ptr = np.arange(n_l1 + 1, dtype=np.int64)
        d1['obj'] = InstanceData(
            ptr, obj_of_seg,
            np.bincount(sup0, minlength=n_l1).astype(np.int64),
            y_of_obj[obj_of_seg])
    d2 = Data(pos=pos2,
              sub=Cluster(sup1, np.arange(n_l1), dense=True),
              edge_index=ei2,
              edge_attr=rng.normal(size=(ei2.shape[1], 7)).astype(
                  np.float32),
              y=hist(n_l2, rng.integers(1, 200, n_l2)),
              normal=_unit(rng, n_l2),
              log_length=rng.random((n_l2, 1)).astype(np.float32),
              log_surface=rng.random((n_l2, 1)).astype(np.float32),
              log_volume=rng.random((n_l2, 1)).astype(np.float32),
              log_size=rng.random((n_l2, 1)).astype(np.float32))
    return NAG([d0, d1, d2])


def _unit(rng, n):
    v = rng.normal(size=(n, 3)).astype(np.float32)
    return v / np.linalg.norm(v, axis=1, keepdims=True)


def synthetic_room_cloud(seed=0, n_points=250_000, extent=(10.0, 8.0, 3.0),
                         n_boxes=12, noise=0.005, num_classes=13):
    """Raw indoor-scan-like point cloud: floor + ceiling + 4 walls +
    axis-aligned furniture boxes, surface-sampled with sensor noise.
    Unlike uniform blobs (the partition's worst case), this matches the
    piecewise-planar statistics real S3DIS rooms feed the partition and
    graph stages — use it for preprocessing benchmarks."""
    rng = np.random.default_rng(seed)
    ex, ey, ez = extent

    def plane(n, origin, u, v, label):
        a = rng.random(n).astype(np.float32)[:, None]
        b = rng.random(n).astype(np.float32)[:, None]
        p = (np.asarray(origin, np.float32)[None]
             + a * np.asarray(u, np.float32)[None]
             + b * np.asarray(v, np.float32)[None])
        return p, np.full(n, label, dtype=np.int64)

    # room shell: ~55% of the points (floor/ceiling/4 walls)
    shell_area = 2 * ex * ey + 2 * ex * ez + 2 * ey * ez
    parts = []
    n_shell = int(n_points * 0.55)
    specs = [((0, 0, 0), (ex, 0, 0), (0, ey, 0), 0),        # floor
             ((0, 0, ez), (ex, 0, 0), (0, ey, 0), 1),       # ceiling
             ((0, 0, 0), (ex, 0, 0), (0, 0, ez), 2),        # walls
             ((0, ey, 0), (ex, 0, 0), (0, 0, ez), 2),
             ((0, 0, 0), (0, ey, 0), (0, 0, ez), 2),
             ((ex, 0, 0), (0, ey, 0), (0, 0, ez), 2)]
    areas = np.array([np.linalg.norm(np.cross(u, v))
                      for _, u, v, _ in specs])
    for (o, u, v, lab), w in zip(specs, areas / areas.sum()):
        parts.append(plane(max(int(n_shell * w), 1), o, u, v, lab))

    # furniture boxes: remaining points over 5 faces each (no bottom)
    n_box = (n_points - sum(p.shape[0] for p, _ in parts)) // max(
        n_boxes, 1)
    for i in range(n_boxes):
        cx, cy = rng.random(2) * [ex - 2, ey - 2] + 1
        sx, sy, sz = rng.random(3) * [1.5, 1.5, 1.2] + 0.2
        lab = 3 + (i % (num_classes - 3))
        faces = [((cx, cy, sz), (sx, 0, 0), (0, sy, 0)),     # top
                 ((cx, cy, 0), (sx, 0, 0), (0, 0, sz)),
                 ((cx, cy + sy, 0), (sx, 0, 0), (0, 0, sz)),
                 ((cx, cy, 0), (0, sy, 0), (0, 0, sz)),
                 ((cx + sx, cy, 0), (0, sy, 0), (0, 0, sz))]
        fa = np.array([np.linalg.norm(np.cross(u, v))
                       for _, u, v in faces])
        for (o, u, v), w in zip(faces, fa / fa.sum()):
            parts.append(plane(max(int(n_box * w), 1), o, u, v, lab))

    pos = np.concatenate([p for p, _ in parts])
    y = np.concatenate([l for _, l in parts])
    pos += rng.normal(0, noise, pos.shape).astype(np.float32)
    # color correlated with label (piecewise-constant + noise)
    base = rng.random((num_classes, 3)).astype(np.float32)
    rgb = np.clip(base[y] + rng.normal(0, 0.05, pos.shape), 0, 1
                  ).astype(np.float32)
    perm = rng.permutation(pos.shape[0])
    return Data(pos=pos[perm].astype(np.float32), rgb=rgb[perm],
                y=y[perm])
