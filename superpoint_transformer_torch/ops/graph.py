"""Graph layout ops on the host (numpy): edge list <-> CSR <-> dense
padded neighbors, a copy of the JAX package's `ops/graph.py`. Edges are
converted once per batch to a dense `[N, K]` neighbor layout so that
attention is dense gathers and a masked softmax. The port's torch segment
ops are in `ops/segment.py`.
"""
import numpy as np

__all__ = [
    'edges_to_dense_neighbors', 'add_self_loops_np', 'untrim_edges_np',
    'to_trimmed_np', 'isolated_nodes_np', 'forward_star_np',
]


def forward_star_np(source, num_nodes):
    """Sort edges by source node; return (perm, pointers) such that
    edge perm[pointers[i]:pointers[i+1]] have source i. Equivalent to
    the reference's grid_graph.edge_list_to_forward_star
    (src/transforms/partition.py:190)."""
    perm = np.argsort(source, kind='stable')
    counts = np.bincount(source, minlength=num_nodes)
    pointers = np.zeros(num_nodes + 1, dtype=np.int64)
    np.cumsum(counts, out=pointers[1:])
    return perm, pointers


def edges_to_dense_neighbors(edge_index, num_nodes, k=None, bucket=16,
                             drop_excess=True):
    """Convert an edge list [2, E] (source=querying node) to dense
    padded neighbor arrays.

    Returns (nbr_idx [N,K] int32, nbr_mask [N,K] bool, edge_id [N,K]
    int32) where edge_id maps each dense slot back to its edge row (for
    gathering edge features); padded slots point at edge 0 / node 0 with
    mask False.

    K is max degree rounded up to a multiple of `bucket` (or the given
    `k`). Below max degree, a given `k` keeps each node's first k edges
    (`drop_excess`) or raises. The default bucket of 16 matches the
    attention kernels' 16-slot tiles.
    """
    source = np.asarray(edge_index[0])
    target = np.asarray(edge_index[1])
    E = source.shape[0]
    perm, pointers = forward_star_np(source, num_nodes)
    deg = (pointers[1:] - pointers[:-1]).astype(np.int64)
    max_deg = int(deg.max()) if E > 0 else 0
    if k is None:
        k = max(_round_up(max_deg, bucket), bucket)
    elif max_deg > k:
        if not drop_excess:
            raise ValueError(
                f"max degree {max_deg} exceeds requested K={k}")
        # keep each node's first k edges (construction order = the
        # radius-graph's score order); a stable-shape alternative to
        # the reference's SampleEdges cap (sampling.py:1234)
        rank_all = np.arange(E, dtype=np.int64) - pointers[source[perm]]
        keep = perm[rank_all < k]
        keep.sort()
        nbr_idx, nbr_mask, edge_id = edges_to_dense_neighbors(
            edge_index[:, keep], num_nodes, k=k, bucket=bucket)
        # edge_id must address the ORIGINAL edge rows (edge features)
        return nbr_idx, nbr_mask, keep[edge_id].astype(np.int32)

    nbr_idx = np.zeros((num_nodes, k), dtype=np.int32)
    nbr_mask = np.zeros((num_nodes, k), dtype=bool)
    edge_id = np.zeros((num_nodes, k), dtype=np.int32)

    if E > 0:
        # rank of each (sorted) edge within its source's neighborhood
        src_sorted = source[perm]
        rank = np.arange(E, dtype=np.int64) - pointers[src_sorted]
        nbr_idx[src_sorted, rank] = target[perm].astype(np.int32)
        edge_id[src_sorted, rank] = perm.astype(np.int32)
        nbr_mask[src_sorted, rank] = True
    return nbr_idx, nbr_mask, edge_id


def add_self_loops_np(edge_index, edge_attr, num_nodes, fill_value=0.0):
    """Add i->i edges for all nodes (reference NAGAddSelfLoops,
    src/transforms/graph.py:1419: self-loop edge_attr = 0)."""
    loops = np.arange(num_nodes, dtype=edge_index.dtype)
    ei = np.concatenate([edge_index, np.stack([loops, loops])], axis=1)
    if edge_attr is not None:
        ea = np.concatenate([
            edge_attr,
            np.full((num_nodes, edge_attr.shape[1]), fill_value,
                    dtype=edge_attr.dtype)], axis=0)
    else:
        ea = None
    return ei, ea


def untrim_edges_np(edge_index, edge_attr=None):
    """A trimmed (i<j unique) graph made bidirectional: every i->j edge
    gives j->i too, with the same attributes (the untrimming of the
    reference's OnTheFlyHorizontalEdgeFeatures, src/transforms/graph.py).
    Returns (edge_index [2, 2E], edge_attr [2E, *] or None)."""
    ei = np.concatenate([edge_index, edge_index[::-1]], axis=1)
    if edge_attr is None:
        return ei, None
    return ei, np.concatenate([edge_attr, edge_attr], axis=0)


def to_trimmed_np(edge_index, edge_attr=None, reduce='mean'):
    """Reduce a graph to its unique i<j edges (reference
    Data.to_trimmed, src/data/data.py:563): flip edges so source<target,
    remove self loops, merge duplicates (reducing edge_attr)."""
    # branch-free flip (min/max), not boolean fancy assignment
    s = np.minimum(edge_index[0], edge_index[1])
    t = np.maximum(edge_index[0], edge_index[1])
    keep = s != t
    s, t = s[keep], t[keep]
    if edge_attr is not None:
        edge_attr = edge_attr[keep]
    # single sort of the fused (s, t) key; duplicate groups are then
    # contiguous runs reduced with np.*.reduceat (one C pass, no
    # scatter). Unstable introsort: group-internal order is
    # irrelevant for the mean/sum/min/max merges and all rows of a
    # group carry the same (s, t)
    key = s.astype(np.int64) * (int(max(t.max(), s.max())) + 1 if s.size
                                else 1) + t.astype(np.int64)
    order = np.argsort(key)
    ks = key[order]
    head = np.ones(ks.shape[0], dtype=bool)
    head[1:] = ks[1:] != ks[:-1]
    starts = np.flatnonzero(head)
    first = order[starts]
    out_ei = np.stack([s[first], t[first]])
    if edge_attr is None:
        return out_ei, None
    ea_sorted = edge_attr[order]
    if reduce == 'mean':
        acc = np.add.reduceat(ea_sorted.astype(np.float64), starts,
                              axis=0)
        cnt = np.diff(np.append(starts, ks.shape[0])).astype(np.float64)
        out_ea = (acc / cnt[:, None]).astype(edge_attr.dtype)
    elif reduce == 'sum':
        out_ea = np.add.reduceat(ea_sorted, starts,
                                 axis=0).astype(edge_attr.dtype)
    elif reduce == 'max':
        out_ea = np.maximum.reduceat(ea_sorted, starts, axis=0)
    elif reduce == 'min':
        out_ea = np.minimum.reduceat(ea_sorted, starts, axis=0)
    else:
        raise ValueError(f"Unknown reduce={reduce}")
    return out_ei, out_ea


def isolated_nodes_np(edge_index, num_nodes):
    """Boolean mask of nodes with no incident edge (reference
    src/utils/graph.py isolated_nodes)."""
    mask = np.ones(num_nodes, dtype=bool)
    mask[edge_index[0]] = False
    mask[edge_index[1]] = False
    return mask


def _round_up(x, m):
    return ((x + m - 1) // m) * m
