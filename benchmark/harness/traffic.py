"""The traffic generator: padded host batches of superpoint graphs, made
with numpy from a seed, as a `DataLoader` worker hands them to the main
process (numpy leaves named as the program's `PaddedNAG` / `PaddedLevel`).

A frozen copy of the program's `utils/synthetic.py:random_padded_nag`,
extended to any number of levels, to neighbor counts drawn to a measured
mean and maximum, to the feature widths of a configuration, and padded
as `data/pad.py:pad_nag` pads with `pow2_fine` buckets. It keeps every
invariant of `pad_nag`:

- each level is sorted by `super_index`, graphs are contiguous, and
  every parent has at least one child of its own graph;
- padded rows have `batch == -1`; padded children have `super_index ==`
  the parent level's capacity;
- padded neighbor slots point at node 0 with the mask False; K is the
  largest valid-slot count rounded up to 16; slot 0 is the self-loop,
  with zero edge features;
- level-1 `node_id` is a permutation of its valid rows;
- with `train`, the label histograms `y` (each graph with its own class
  mix, Dirichlet(0.5)) and the transpose neighbor tables `nbr_in_idx` /
  `nbr_in_mask` of the levels with neighbors.
"""
from dataclasses import dataclass
from typing import Optional, Tuple

import numpy as np

__all__ = ['HostLevel', 'HostBatch', 'bucket', 'make_batch', 'batch_sizes',
           'transpose_neighbors']


@dataclass
class HostLevel:
    pos: np.ndarray
    node_mask: np.ndarray
    batch: np.ndarray
    num_nodes: np.int32
    x: Optional[np.ndarray] = None
    node_size: Optional[np.ndarray] = None
    super_index: Optional[np.ndarray] = None
    nbr_idx: Optional[np.ndarray] = None
    nbr_mask: Optional[np.ndarray] = None
    edge_feat: Optional[np.ndarray] = None
    y: Optional[np.ndarray] = None
    nbr_in_idx: Optional[np.ndarray] = None
    nbr_in_mask: Optional[np.ndarray] = None
    node_id: Optional[np.ndarray] = None


@dataclass
class HostBatch:
    levels: Tuple[HostLevel, ...]
    start_i_level: int = 0
    num_graphs: int = 1


def _round_up(n, q):
    return -(-int(n) // q) * q


def bucket(n, minimum=128):
    """`pad_nag`'s `pow2_fine` capacity: each power-of-two octave in 8
    steps (quantum 2^(k-3), at least 128)."""
    n = max(int(n), minimum)
    k = (n - 1).bit_length()
    return _round_up(n, max(1 << max(k - 3, 0), 128))


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


def _degrees(rng, n, mean, top, sizes_of_rows):
    """Valid-slot counts (self-loop included) of `n` nodes: a normal
    around `mean` (sd mean/3) rounded and clipped to [2, top], with one
    node at `top`, none above its graph's size."""
    deg = np.clip(np.rint(rng.normal(mean, mean / 3.0, n)), 2, top)
    deg[rng.integers(0, n)] = top
    return np.minimum(deg.astype(np.int64), sizes_of_rows)


def _neighbors(rng, batch, sizes, deg, cap, edge_dim):
    """Dense neighbor table: slot 0 is the self-loop, the other valid
    slots point at random nodes of the same graph."""
    n = batch.shape[0]
    start = np.concatenate([[0], np.cumsum(sizes)[:-1]])
    K = max(_round_up(int(deg.max()), 16), 16)
    idx = start[batch][:, None] + (
        rng.random((n, K), dtype=np.float32)
        * sizes[batch][:, None]).astype(np.int64)
    idx[:, 0] = np.arange(n)
    mask = np.arange(K)[None, :] < deg[:, None]
    idx = np.where(mask, idx, 0)
    ef = np.zeros((cap, K, edge_dim), np.float32)
    ef[:n] = rng.standard_normal((n, K, edge_dim), dtype=np.float32)
    ef[np.arange(n), 0] = 0.0      # self-loops carry zero features
    return _pad(idx.astype(np.int32), cap), _pad(mask, cap, False), ef


def _histogram(rng, sizes, graph, mix):
    """Label histograms [n, C+1] (the last column void): each node's mass
    on one class drawn from its graph's class mix `mix` [G, C] (rooms and
    tiles differ in what they hold), and a quarter of it on a second
    class or void."""
    n, C = sizes.shape[0], mix.shape[1]
    y = np.zeros((n, C + 1), dtype=np.float32)
    rows = np.arange(n)
    cls = (rng.random(n)[:, None] > np.cumsum(mix, 1)[graph]).sum(1)
    y[rows, np.minimum(cls, C - 1)] += sizes
    y[rows, rng.integers(0, C + 1, n)] += np.ceil(sizes / 4)
    return y


def transpose_neighbors(nbr_idx, nbr_mask):
    """The transpose of a padded neighbor table [cap, K] (`pad_nag`'s):
    for each node m, the flattened [cap*K] slots (n, k) with
    nbr_idx[n, k] == m, in slot order, as (in_idx, in_mask) [cap, K_in];
    K_in is the largest in-degree rounded up to 16 (at least 16)."""
    cap = nbr_idx.shape[0]
    tgt = nbr_idx[nbr_mask]
    slots = np.flatnonzero(nbr_mask.reshape(-1)).astype(np.int64)
    order = np.argsort(tgt, kind='stable')
    tgt_s, slots_s = tgt[order], slots[order]
    deg_in = np.bincount(tgt_s, minlength=cap)
    k_in = int(max(_round_up(int(deg_in.max(initial=0)), 16), 16))
    in_idx = np.zeros((cap, k_in), dtype=np.int32)
    in_mask = np.zeros((cap, k_in), dtype=bool)
    starts = np.zeros(cap + 1, dtype=np.int64)
    np.cumsum(deg_in, out=starts[1:])
    rank = np.arange(slots_s.shape[0]) - starts[tgt_s]
    in_idx[tgt_s, rank] = slots_s
    in_mask[tgt_s, rank] = True
    return in_idx, in_mask


def make_batch(seed, graphs, levels, point_dim, edge_dim, num_classes,
               extent, train=False):
    """A padded batch of `graphs` graphs. `levels` lists, from level 0
    up, {'nodes': mean nodes a graph, 'spread': metres of a node around
    its parent (the top level: uniform over `extent`)} and, on levels 1
    and up, 'degree_mean' and 'degree_max' (valid slots, self-loop
    included). Node counts are drawn +-10% a graph. Level 0 carries
    `point_dim` features; neighbor slots carry `edge_dim` ones."""
    rng = np.random.default_rng(seed)
    G, L = graphs, len(levels) - 1
    sizes = [None] * (L + 1)
    sizes[L] = _sizes(rng, levels[L]['nodes'], G)
    for l in range(L - 1, -1, -1):
        sizes[l] = np.maximum(_sizes(rng, levels[l]['nodes'], G),
                              sizes[l + 1])
    sup = [_children(rng, sizes[l], sizes[l + 1]) for l in range(L)]
    bat = [None] * (L + 1)
    bat[L] = np.repeat(np.arange(G), sizes[L])
    for l in range(L - 1, -1, -1):
        bat[l] = bat[l + 1][sup[l]]
    n = [b.shape[0] for b in bat]
    caps = [bucket(k) for k in n]

    # positions: the top level uniform over the extent, children
    # scattered around their parents
    pos = [None] * (L + 1)
    pos[L] = (rng.random((n[L], 3)) * extent).astype(np.float32)
    for l in range(L - 1, -1, -1):
        pos[l] = pos[l + 1][sup[l]] + rng.normal(
            0, levels[l]['spread'], (n[l], 3)).astype(np.float32)
    size = [np.ones(n[0], np.float32)]
    for l in range(1, L + 1):
        size.append(np.bincount(sup[l - 1], weights=size[l - 1],
                                minlength=n[l]).astype(np.float32))
    # a parent's position is its children's mean, as a partition's is
    for l in range(1, L + 1):
        c = np.bincount(sup[l - 1], minlength=n[l]).astype(np.float32)
        pos[l] = (np.stack([np.bincount(sup[l - 1], pos[l - 1][:, i],
                                        minlength=n[l]) for i in range(3)],
                           1) / c[:, None]).astype(np.float32)

    mix = rng.dirichlet(np.full(num_classes, 0.5), G) if train else None
    out = []
    for l in range(L + 1):
        kw = {}
        if l < L:
            kw['super_index'] = _pad(sup[l].astype(np.int32), caps[l],
                                     caps[l + 1])
        if l == 0:
            kw['x'] = _pad(rng.random((n[0], point_dim), dtype=np.float32),
                           caps[0])
        else:
            deg = _degrees(rng, n[l], levels[l]['degree_mean'],
                           levels[l]['degree_max'], sizes[l][bat[l]])
            idx, mask, ef = _neighbors(rng, bat[l], sizes[l], deg, caps[l],
                                       edge_dim)
            kw.update(nbr_idx=idx, nbr_mask=mask, edge_feat=ef)
            if train:
                kw['nbr_in_idx'], kw['nbr_in_mask'] = transpose_neighbors(
                    idx, mask)
        if l == 1:
            kw['node_id'] = _pad(rng.permutation(n[1]).astype(np.int32),
                                 caps[1], -1)
        if train:
            kw['y'] = _pad(_histogram(rng, size[l], bat[l], mix), caps[l])
        out.append(HostLevel(
            pos=_pad(pos[l], caps[l]),
            node_mask=_pad(np.ones(n[l], bool), caps[l], False),
            batch=_pad(bat[l].astype(np.int32), caps[l], -1),
            num_nodes=np.int32(n[l]), node_size=_pad(size[l], caps[l]),
            **kw))
    return HostBatch(levels=tuple(out), start_i_level=0, num_graphs=G)


def batch_sizes(batch):
    """[(valid nodes, valid neighbor slots)] of each level of a host
    batch, from level 0 up (0 slots on a level without neighbors)."""
    return [(int(l.num_nodes),
             0 if l.nbr_mask is None else int(l.nbr_mask.sum()))
            for l in batch.levels]
