"""Graph components for the EZ-SP learned partition.

Counterpart of `superpoint_transformer_tpu/ops/components.py`: connected
components by label max-propagation (`wcc_by_max_propagation` on
tensors, `wcc_by_max_propagation_np` on the host), the contraction of a
graph to its component graph, and the greedy contour-prior merge, which
runs the native solver (`ops/native.py:greedy_cut`) on the energy

    E(P) = sum_c  sum_{i in c} s_i ||x_i - mu_c||^2  +  reg * |contour|

with |contour| the total weight of the edges between components: a
merge is taken while it lowers E, then every component under `min_size`
joins its best neighbor.
"""
import numpy as np
import torch

from .native import greedy_cut, radius_knn

__all__ = [
    'wcc_by_max_propagation', 'wcc_by_max_propagation_np',
    'consecutive_np', 'component_graph_np',
    'merge_components_by_contour_prior_np', 'connect_isolated_knn_np',
]


def wcc_by_max_propagation(num_nodes, edge_index, edge_mask=None,
                           max_iterations=-1):
    """Weakly connected components of a graph on any device: int32
    [num_nodes] labels, each component labeled by its largest member id
    (not consecutive; see `consecutive_np`).

    Every node starts with its own id; each round it takes the largest
    label of itself and its neighbors (both edge directions), then the
    label of its label (pointer jumping, which ends path graphs in
    O(log N) rounds), until no label changes or `max_iterations` rounds
    (<= 0: `num_nodes`). Edges where `edge_mask` is False are left out."""
    src = edge_index[0].long()
    dst = edge_index[1].long()
    device = src.device
    if edge_mask is None:
        edge_mask = torch.ones(src.shape[0], dtype=torch.bool,
                               device=device)
    # masked edges scatter into a dump row past the last node
    dump = torch.full_like(src, num_nodes)
    srcm = torch.where(edge_mask, src, dump)
    dstm = torch.where(edge_mask, dst, dump)
    src_g = src.clamp(0, max(num_nodes - 1, 0))
    dst_g = dst.clamp(0, max(num_nodes - 1, 0))
    max_it = max_iterations if max_iterations > 0 else num_nodes
    labels = torch.arange(num_nodes, dtype=torch.int64, device=device)
    for _ in range(max_it):
        new = torch.cat([labels, labels.new_zeros(1)])
        new.scatter_reduce_(0, srcm, labels[dst_g], 'amax')
        new.scatter_reduce_(0, dstm, labels[src_g], 'amax')
        new = new[:num_nodes]
        new = torch.maximum(new, new[new])
        changed = bool((new != labels).any())
        labels = new
        if not changed:
            break
    return labels.to(torch.int32)


def consecutive_np(labels):
    """Relabel to consecutive 0..C-1 in the order of the sorted label
    values. Returns (int64 labels, C)."""
    uniq, inv = np.unique(np.asarray(labels), return_inverse=True)
    return inv.astype(np.int64), int(uniq.shape[0])


def wcc_by_max_propagation_np(num_nodes, edge_index, max_iterations=-1):
    """Host wrapper: the propagation on CPU tensors, then consecutive
    labels. Returns (super_index [N] int64, number of components)."""
    if edge_index.shape[1] == 0:
        return np.arange(num_nodes, dtype=np.int64), num_nodes
    labels = wcc_by_max_propagation(
        int(num_nodes), torch.from_numpy(
            np.asarray(edge_index, dtype=np.int64)),
        max_iterations=max_iterations)
    return consecutive_np(labels.numpy())


def component_graph_np(super_index, edge_index, edge_weight=None,
                       reduce='add', no_self_loops=True):
    """Contract a graph to its component graph: endpoints mapped through
    `super_index`, self-loops dropped (with `no_self_loops`), and the
    weights of duplicate undirected edges combined by `reduce` ('add',
    'mean', 'max', 'min' or 'mul'). Returns (edge_index [2, E'] with
    source < target, weights [E'])."""
    I = np.asarray(super_index)
    src, dst = I[edge_index[0]], I[edge_index[1]]
    w = np.ones(src.shape[0], dtype=np.float32) if edge_weight is None \
        else np.asarray(edge_weight, dtype=np.float32).reshape(-1)
    if no_self_loops:
        keep = src != dst
        src, dst, w = src[keep], dst[keep], w[keep]
    if src.shape[0] == 0:
        return np.zeros((2, 0), dtype=np.int64), w[:0]
    lo, hi = np.minimum(src, dst), np.maximum(src, dst)
    n = int(I.max()) + 1 if I.size else 0
    key = lo.astype(np.int64) * max(n, 1) + hi
    order = np.argsort(key, kind='stable')
    key, lo, hi, w = key[order], lo[order], hi[order], w[order]
    first = np.ones(key.shape[0], dtype=bool)
    first[1:] = key[1:] != key[:-1]
    gid = np.cumsum(first) - 1
    n_out = int(gid[-1]) + 1
    if reduce == 'add':
        w_out = np.zeros(n_out, w.dtype)
        np.add.at(w_out, gid, w)
    elif reduce == 'mean':
        w_out = np.zeros(n_out, w.dtype)
        cnt = np.zeros(n_out, np.int64)
        np.add.at(w_out, gid, w)
        np.add.at(cnt, gid, 1)
        w_out = w_out / np.maximum(cnt, 1)
    elif reduce == 'max':
        w_out = np.full(n_out, -np.inf, w.dtype)
        np.maximum.at(w_out, gid, w)
    elif reduce == 'min':
        w_out = np.full(n_out, np.inf, w.dtype)
        np.minimum.at(w_out, gid, w)
    elif reduce == 'mul':
        w_out = np.ones(n_out, w.dtype)
        np.multiply.at(w_out, gid, w)
    else:
        raise ValueError(f"unknown reduce '{reduce}'")
    ei = np.stack([lo[first], hi[first]]).astype(np.int64)
    return ei, w_out


def merge_components_by_contour_prior_np(
        x, size, edge_index, edge_weight, reg, min_size,
        merge_only_small=False, pos=None, k=0, w_adjacency=0.0,
        edge_reduce='add'):
    """Greedy contour-prior merge of a component graph: mean features
    `x` [C, D], sizes `size` [C], a trimmed `edge_index` [2, E] and its
    weights. Components merge while a merge lowers the energy (with
    `merge_only_small`, the contour reward is off and only the
    `min_size` pass merges), then every component under `min_size`
    joins its best neighbor. With `k > 0`, isolated components are first
    joined to their k nearest neighbors in `pos`.

    Returns (labels [C] int64, number of merged components,
    (x, size, edge_index, edge_weight, pos) of the merged graph)."""
    x = np.asarray(x, np.float32)
    size = np.asarray(size, np.float32).reshape(-1)
    ei, w = edge_index, edge_weight
    if k > 0 and pos is not None:
        ei, w = connect_isolated_knn_np(ei, w, np.asarray(pos), k,
                                        w_adjacency)
    reg_eff = 0.0 if merge_only_small else float(reg)
    labels, n_merged = greedy_cut(
        x, ei, edge_weight=w, node_weight=size,
        reg=reg_eff, cutoff=float(min_size))
    size_m = np.zeros(n_merged, np.float32)
    np.add.at(size_m, labels, size)
    x_m = np.zeros((n_merged, x.shape[1]), np.float32)
    np.add.at(x_m, labels, x * size[:, None])
    x_m /= np.maximum(size_m[:, None], 1e-12)
    pos_m = None
    if pos is not None:
        pos = np.asarray(pos, np.float32)
        pos_m = np.zeros((n_merged, pos.shape[1]), np.float32)
        np.add.at(pos_m, labels, pos * size[:, None])
        pos_m /= np.maximum(size_m[:, None], 1e-12)
    ei_m, w_m = component_graph_np(labels, ei, w, reduce=edge_reduce)
    return labels, n_merged, (x_m, size_m, ei_m, w_m, pos_m)


def connect_isolated_knn_np(edge_index, edge_weight, pos, k,
                            w_adjacency=0.0):
    """Join every isolated node (degree 0) to its k nearest neighbors in
    `pos`; the new edges weigh 1 where `w_adjacency <= 0`, else
    `1 / (w_adjacency + d / mean(d))`."""
    n = pos.shape[0]
    deg = np.zeros(n, np.int64)
    if edge_index.shape[1]:
        np.add.at(deg, edge_index[0], 1)
        np.add.at(deg, edge_index[1], 1)
    iso = np.where(deg == 0)[0]
    if iso.size == 0 or n < 2:
        return edge_index, edge_weight
    kk = min(k, n - 1)
    # one neighbor more: each query is in the search set, and its
    # nearest hit, itself, is dropped below
    nbr, dist = radius_knn(pos.astype(np.float32),
                           pos[iso].astype(np.float32),
                           r=np.inf, k=kk + 1, exclude_self=False)
    src = np.repeat(iso, kk + 1)
    dst = nbr.reshape(-1).astype(np.int64)
    d = dist.reshape(-1)
    keep = (dst >= 0) & (dst != src) & np.isfinite(d)
    src, dst, d = src[keep], dst[keep], d[keep]
    if w_adjacency > 0 and d.size:
        w_new = 1.0 / (w_adjacency + d / max(d.mean(), 1e-12))
    else:
        w_new = np.ones(src.shape[0], np.float32)
    ei = np.concatenate([edge_index, np.stack([src, dst])], axis=1)
    w = np.concatenate([
        np.asarray(edge_weight, np.float32).reshape(-1),
        w_new.astype(np.float32)])
    return ei, w
