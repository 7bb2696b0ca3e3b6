"""The level-1 instance graph of SuperCluster's traffic, drawn onto the
batches of the generator (`traffic.py`) with numpy from a seed.

The port's preprocessing of a DALES-density tile under
experiment=panoptic/dales (radius-atomic, r 0.1 m, k_max 30) joins a
sparse set of superpoints: ~0.27-0.30 edges a level-1 node, the node of
most edges at 6-8, over 99% of the edges between horizontal neighbors
(`configs/supercluster_dales.json`, `clouds`). So each batch's graph is
drawn among its level-1 neighbor slots: one node joined to
`degree_max` of its neighbors, then distinct pairs of a random node and
one of its neighbors, each end below `degree_max` edges, up to
`edges_per_node` times the valid nodes. Each edge (u, v) is stored once,
in a random direction, and padded as `data/pad.py:pad_nag` pads
`obj_edge_index` (int32 [2, cap], padded edges (0, 0) with
`obj_edge_mask` False).
"""
import numpy as np

from .common import make_pool
from .traffic import bucket

__all__ = ['draw_instance_graph', 'make_panoptic_pool']


def draw_instance_graph(level, edges_per_node, degree_max, rng):
    """(obj_edge_index int32 [2, cap], obj_edge_mask bool [cap]) of a
    host level with neighbor slots (`nbr_idx`, `nbr_mask`; slot 0 the
    self-loop)."""
    n = int(level.num_nodes)
    idx, mask = level.nbr_idx[:n], level.nbr_mask[:n].copy()
    mask[:, 0] = False
    deg = np.zeros(n, np.int64)
    seen, out = set(), []

    def add(u, v):
        key = (min(u, v), max(u, v))
        if u == v or key in seen or deg[u] >= degree_max \
                or deg[v] >= degree_max:
            return
        seen.add(key)
        deg[u] += 1
        deg[v] += 1
        out.append((u, v) if rng.random() < 0.5 else (v, u))

    hub = int(rng.integers(0, n))
    for v in rng.permutation(idx[hub][mask[hub]]).tolist():
        add(hub, int(v))
    target = int(round(edges_per_node * n))
    rows, slots = np.nonzero(mask)
    for k in rng.permutation(rows.shape[0]).tolist():
        if len(out) >= target:
            break
        add(int(rows[k]), int(idx[rows[k], slots[k]]))
    e = np.asarray(out, np.int64).reshape(-1, 2).T
    cap = bucket(e.shape[1])
    oei = np.zeros((2, cap), np.int32)
    oei[:, :e.shape[1]] = e
    oem = np.zeros(cap, bool)
    oem[:e.shape[1]] = True
    return oei, oem


def make_panoptic_pool(cfg, traffic, seed):
    """`make_pool`'s serving batches of `traffic`, each with a level-1
    instance graph of `traffic['instance_graph']` ({'edges_per_node',
    'degree_max'}) drawn from `seed` and the batch's place in the pool;
    and their valid sizes."""
    pool, sizes = make_pool(cfg, traffic, seed, train=False)
    g = traffic['instance_graph']
    for b, batch in enumerate(pool):
        rng = np.random.default_rng([int(seed) % (2 ** 63), b, 1])
        lvl = batch.levels[1]
        lvl.obj_edge_index, lvl.obj_edge_mask = draw_instance_graph(
            lvl, g['edges_per_node'], g['degree_max'], rng)
    return pool, sizes
