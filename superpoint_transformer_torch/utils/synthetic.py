"""Synthetic data, numpy only: padded NAG batches
(`random_padded_nag`), and copies of the JAX package's `random_nag`
(a small 3-level NAG), `synthetic_room_cloud` (a raw indoor cloud
for the preprocessing path) and `synthetic_aerial_cloud` (a raw aerial
tile, the same arrays as JAX's for a seed); and writers of such clouds
in the raw formats of DALES, KITTI-360 and ScanNet, so that their
readers and datasets run without downloaded data.

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
import json
import os
import os.path as osp

import numpy as np

from ..data.csr import Cluster, InstanceData
from ..data.data import Data
from ..data.nag import NAG
from ..data.pad import bucket, transpose_neighbors
from ..data.padded import PaddedLevel, PaddedNAG
from ..ops.graph import _round_up
from .ply import write_ply

__all__ = ['random_padded_nag', 'random_nag', 'synthetic_room_cloud',
           'synthetic_aerial_cloud', 'room_instances', 'write_dales_tile',
           'write_kitti360_window', 'write_scannet_scan', 'POINT_HF_DIM',
           'EDGE_HF_DIM']

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
                      node_caps=None, n_l3=None, point_dim=POINT_HF_DIM):
    """A padded 3-level batch of `num_graphs` graphs, each with about
    `n_points` level-0 points, `n_l1` level-1 and `n_l2` level-2 nodes
    (+-10% per graph), and a valid-neighbor count (self-loop included)
    drawn from `degree` at levels 1 and up; with `n_l3`, a fourth level
    of about that many nodes a graph (SPT-3's). Level 0 carries
    `point_dim` features. `node_caps` (level -> capacity, as `pad_nag`'s)
    overrides the bucketed capacities; the node counts do not depend on
    it. Returns a `PaddedNAG` with numpy leaves, the layout of the JAX
    host path's output; convert it with `data.padded.from_numpy`."""
    rng = np.random.default_rng(seed)
    G = num_graphs
    want = [n_points, n_l1, n_l2] + ([] if n_l3 is None else [n_l3])
    L = len(want) - 1
    s = [None] * L + [_sizes(rng, want[L], G)]
    for i in range(L - 1, -1, -1):
        s[i] = np.maximum(_sizes(rng, want[i], G), s[i + 1])
    b = [None] * L + [np.repeat(np.arange(G), s[L])]
    sup = [None] * L
    for i in range(L - 1, -1, -1):
        sup[i] = _children(rng, s[i], s[i + 1])
        b[i] = b[i + 1][sup[i]]
    n = [len(bi) for bi in b]
    cap = [(node_caps or {}).get(i) or bucket(k) for i, k in enumerate(n)]

    # room-scale positions: children scattered around their parents
    # (metres: 2.0 a level-2 node about its level-3 parent, 1.0 a level-1
    # node, 0.2 a point)
    c = (rng.random((n[L], 3)) * [10.0, 8.0, 3.0]).astype(np.float32)
    for i, spread in ((2, 2.0), (1, 1.0), (0, 0.2)):
        if i < L:
            c = c[sup[i]] + rng.normal(0, spread, (n[i], 3)).astype(
                np.float32)
    pos, size = [c], [np.ones(n[0], np.float32)]
    for i in range(1, L + 1):
        cnt = np.bincount(sup[i - 1], minlength=n[i]).astype(np.float32)
        pos.append((np.stack([np.bincount(sup[i - 1], pos[-1][:, j],
                                          minlength=n[i])
                              for j in range(3)], 1)
                    / cnt[:, None]).astype(np.float32))
        size.append(np.bincount(sup[i - 1], weights=size[-1],
                                minlength=n[i]).astype(np.float32))

    def level(i, **kw):
        if i < L:
            kw['super_index'] = _pad(sup[i].astype(np.int32), cap[i],
                                     cap[i + 1])
        return PaddedLevel(
            pos=_pad(pos[i], cap[i]),
            node_mask=_pad(np.ones(n[i], bool), cap[i], False),
            batch=_pad(b[i].astype(np.int32), cap[i], -1),
            num_nodes=np.int32(n[i]), node_size=_pad(size[i], cap[i]),
            **kw)

    def labels(i):
        return _pad(_histogram(rng, size[i], num_classes), cap[i])

    nbrs = {i: _neighbors(rng, b[i], s[i], degree, cap[i])
            for i in range(1, L + 1)}
    y = labels(0)
    levels = [level(0, y=y, x=_pad(rng.random((n[0], point_dim)).astype(
        np.float32), cap[0]))]
    for i in range(1, L + 1):
        nbr, m, ef = nbrs[i]
        inn, im = transpose_neighbors(nbr, m)
        kw = dict(y=labels(i), nbr_idx=nbr, nbr_mask=m, edge_feat=ef,
                  nbr_in_idx=inn, nbr_in_mask=im)
        if i == 1:
            kw['node_id'] = _pad(rng.permutation(n[1]).astype(np.int32),
                                 cap[1], -1)
        levels.append(level(i, **kw))
    return PaddedNAG(levels=tuple(levels), start_i_level=0, num_graphs=G)


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


def synthetic_aerial_cloud(seed=0, n_points=120_000,
                           extent=(60.0, 40.0), n_buildings=5,
                           noise=0.02, num_classes=13):
    """Outdoor/aerial-survey-like tile: undulating ground, buildings
    with LONG planar walls and flat roofs, linear power-line spans and
    scattered vegetation blobs — the DALES-like statistics (large
    planar surfaces with high aspect ratio) that stress a merge-only
    partition solver very differently from indoor rooms.

    Returns (Data(pos, rgb, y), planted) where `planted` assigns each
    point the id of its generating primitive (one id per planar face /
    line / blob): the planted piecewise-planar partition used as the
    energy competitor in the solver-parity goldens
    (tests/test_solver_parity.py)."""
    rng = np.random.default_rng(seed)
    ex, ey = extent
    parts = []  # (pos, label)

    def add(p, label):
        parts.append((p.astype(np.float32),
                      np.full(p.shape[0], label, dtype=np.int64)))

    def ground_z(xy):
        return (0.4 * np.sin(xy[:, 0] * 0.15)
                + 0.3 * np.cos(xy[:, 1] * 0.21)
                + 0.01 * xy[:, 0]).astype(np.float32)

    # ground: ~50% of points over the full tile (label 0)
    n_ground = int(n_points * 0.5)
    xy = rng.random((n_ground, 2)).astype(np.float32) * [ex, ey]
    add(np.column_stack([xy, ground_z(xy)]), 0)

    # buildings: long walls (aspect ratio >= 5) + flat roof (label 2)
    n_bld = int(n_points * 0.35) // max(n_buildings, 1)
    for i in range(n_buildings):
        cx = rng.random() * (ex - 20) + 4
        cy = rng.random() * (ey - 12) + 3
        L = rng.random() * 10 + 8          # long side
        W = rng.random() * 4 + 3
        H = rng.random() * 5 + 4
        z0 = float(ground_z(np.array([[cx, cy]]))[0])
        faces = [((cx, cy, z0 + H), (L, 0, 0), (0, W, 0)),   # roof
                 ((cx, cy, z0), (L, 0, 0), (0, 0, H)),       # walls
                 ((cx, cy + W, z0), (L, 0, 0), (0, 0, H)),
                 ((cx, cy, z0), (0, W, 0), (0, 0, H)),
                 ((cx + L, cy, z0), (0, W, 0), (0, 0, H))]
        areas = np.array([np.linalg.norm(np.cross(u, v))
                          for _, u, v in faces])
        for (o, u, v), w in zip(faces, areas / areas.sum()):
            m = max(int(n_bld * w), 8)
            a = rng.random(m).astype(np.float32)[:, None]
            b = rng.random(m).astype(np.float32)[:, None]
            p = (np.asarray(o, np.float32)[None]
                 + a * np.asarray(u, np.float32)[None]
                 + b * np.asarray(v, np.float32)[None])
            add(p, 2)

    # power lines: long thin catenary-like spans (label 3)
    n_line = int(n_points * 0.05) // 3
    for i in range(3):
        x0, y0 = rng.random(2) * [ex * 0.2, ey]
        x1, y1 = ex * 0.8 + rng.random() * ex * 0.2, rng.random() * ey
        t = rng.random(max(n_line, 16)).astype(np.float32)
        sag = 1.5 * (t - 0.5) ** 2 * 4 - 1.5
        p = np.column_stack([x0 + t * (x1 - x0), y0 + t * (y1 - y0),
                             9.0 + sag + i * 0.4])
        add(p, 3)

    # vegetation: scattered ellipsoidal blobs (label 1)
    n_veg_total = n_points - sum(p.shape[0] for p, _ in parts)
    n_blobs = 8
    for i in range(n_blobs):
        m = max(n_veg_total // n_blobs, 16)
        c = rng.random(2) * [ex, ey]
        z0 = float(ground_z(c[None])[0])
        r = rng.random(3) * [1.5, 1.5, 2.0] + [0.8, 0.8, 1.0]
        p = rng.normal(size=(m, 3)).astype(np.float32) * r * 0.5 \
            + [c[0], c[1], z0 + r[2] + 0.5]
        add(p, 1)

    pos = np.concatenate([p for p, _ in parts])
    y = np.concatenate([l for _, l in parts])
    planted = np.concatenate([
        np.full(p.shape[0], i, dtype=np.int64)
        for i, (p, _) in enumerate(parts)])
    pos += rng.normal(0, noise, pos.shape).astype(np.float32)
    base = rng.random((num_classes, 3)).astype(np.float32)
    rgb = np.clip(base[y] + rng.normal(0, 0.05, pos.shape), 0, 1
                  ).astype(np.float32)
    perm = rng.permutation(pos.shape[0])
    return (Data(pos=pos[perm].astype(np.float32), rgb=rgb[perm],
                 y=y[perm]), planted[perm])


# the synthetic classes in each dataset's raw label ids: the aerial
# tile's ground, vegetation, buildings and power lines as DALES ids
# (1 ground, 2 vegetation, 8 buildings, 5 power lines) and KITTI-360 ids
# (7 road, 21 vegetation, 11 building, 17 pole); the room's floor,
# ceiling, walls and 10 furniture classes as NYU40 ids (the ceiling, 22,
# is no ScanNet class)
AERIAL_TO_DALES = np.asarray([1, 2, 8, 5], np.uint8)
AERIAL_TO_KITTI360 = np.asarray([7, 21, 11, 17], np.int32)
ROOM_TO_NYU40 = np.asarray([2, 22, 1, 3, 4, 5, 6, 7, 8, 9, 10, 14, 39],
                           np.uint16)


def _xyz(cloud):
    return {c: np.ascontiguousarray(cloud.pos[:, i])
            for i, c in enumerate('xyz')}


def _rgb8(cloud):
    rgb = np.round(np.asarray(cloud.rgb, np.float32) * 255).astype(np.uint8)
    return {c: np.ascontiguousarray(rgb[:, i])
            for i, c in enumerate(('red', 'green', 'blue'))}


def room_instances(cloud):
    """Per-point instance ids of a synthetic room: two objects a class,
    split at every metre of x (the recipe of tests/test_panoptic.py)."""
    return (cloud.y * 2 + (cloud.pos[:, 0] % 2 < 1)).astype(np.int64)


def write_dales_tile(path, cloud):
    """Write a `synthetic_aerial_cloud` as a DALES tile (`x y z intensity
    sem_class ins_class`, binary PLY). Intensity follows the colour (a
    raw reading up to 6e4), instances are the generator's primitives
    when `cloud` carries `planted`, else 0."""
    inten = np.asarray(cloud.rgb, np.float32).mean(1) * np.float32(6e4)
    planted = cloud.get('planted')
    write_ply(path, {
        **_xyz(cloud), 'intensity': inten.astype(np.float32),
        'sem_class': AERIAL_TO_DALES[cloud.y],
        'ins_class': (np.zeros(cloud.num_nodes, np.int32) if planted is None
                      else np.asarray(planted, np.int32))})


def write_kitti360_window(path, cloud):
    """Write a `synthetic_aerial_cloud` as a KITTI-360 window (`x y z red
    green blue semantic instance`, binary PLY; instance = semantic id *
    1000, one instance a class)."""
    sem = AERIAL_TO_KITTI360[cloud.y]
    write_ply(path, {**_xyz(cloud), **_rgb8(cloud), 'semantic': sem,
                     'instance': sem * 1000})


def write_scannet_scan(scan_dir, cloud, cell=0.5):
    """Write a `synthetic_room_cloud` as a ScanNet scan directory: the
    mesh vertices, the NYU40 labels, the over-segmentation (each segment
    the points of one `room_instances` object in one `cell`-sized cube)
    and the aggregation, whose groups are every object's segments but
    the ceiling's (void in ScanNet): those vertices belong to no
    group."""
    os.makedirs(scan_dir, exist_ok=True)
    scan = osp.basename(scan_dir.rstrip('/'))
    base = {**_xyz(cloud), **_rgb8(cloud)}
    write_ply(osp.join(scan_dir, f'{scan}_vh_clean_2.ply'), base)
    write_ply(osp.join(scan_dir, f'{scan}_vh_clean_2.labels.ply'),
              {**base, 'label': ROOM_TO_NYU40[cloud.y]})
    obj = room_instances(cloud)
    cube = np.floor(cloud.pos / cell).astype(np.int64)
    cube -= cube.min(0)
    key = np.column_stack([obj, cube])
    _, seg = np.unique(key, axis=0, return_inverse=True)
    seg = seg.reshape(-1)
    with open(osp.join(scan_dir, f'{scan}_vh_clean_2.0.010000.segs.json'),
              'w') as f:
        json.dump({'sceneId': scan, 'segIndices': seg.tolist()}, f)
    groups = []
    for i, o in enumerate(np.unique(obj[cloud.y != 1])):
        groups.append({'id': i, 'objectId': i,
                       'segments': np.unique(seg[obj == o]).tolist(),
                       'label': str(int(ROOM_TO_NYU40[o // 2]))})
    with open(osp.join(scan_dir, f'{scan}.aggregation.json'), 'w') as f:
        json.dump({'sceneId': scan, 'segGroups': groups}, f)
