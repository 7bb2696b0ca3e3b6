"""Instance-overlap operations on CSR `InstanceData` (numpy), a copy of
the JAX package's `ops/instance.py`: each cluster's major instance, the
instance graph's target affinities, object centroids, overlap IoUs and
the void search and removal of panoptic matching. No dense mask is
built.
"""
import numpy as np

from ..data.csr import InstanceData
from .graph import to_trimmed_np

__all__ = ['instance_major', 'instance_graph_affinity',
           'estimate_instance_centroid', 'instance_iou_and_size',
           'instance_search_void', 'instance_remove_void']


def instance_major(inst: InstanceData, num_classes=None):
    """For each cluster, the instance it overlaps most: returns
    (obj_id [Nc], overlap_count [Nc], semantic_label y [Nc]).

    Void fallback (arXiv 1801.00868 semantics): a cluster whose major
    overlap is a void object but covers <= 50% of the cluster is
    reassigned to its best NON-void overlap — only clusters with >50%
    void overlap keep a void major (and get excluded from metrics
    downstream)."""
    n = inst.num_groups
    idx = inst.to_super_index()
    obj = np.full(n, -1, dtype=np.int64)
    cnt = np.zeros(n, dtype=np.int64)
    y = np.full(n, num_classes if num_classes is not None else -1,
                dtype=np.int64)

    def best(count_key):
        order = np.lexsort((-count_key, idx))
        first = np.ones(order.shape[0], dtype=bool)
        first[1:] = idx[order][1:] != idx[order][:-1]
        return order[first]

    rows = best(inst.count)
    obj[idx[rows]] = inst.obj[rows]
    cnt[idx[rows]] = inst.count[rows]
    y[idx[rows]] = inst.y[rows]
    if num_classes is None:
        return obj, cnt, y

    is_major_void = (y < 0) | (y >= num_classes)
    # exclude the placeholder label of clusters with no overlaps
    has_rows = np.zeros(n, dtype=bool)
    has_rows[idx[rows]] = True
    is_major_void &= has_rows
    if not is_major_void.any():
        return obj, cnt, y

    total = np.zeros(n, dtype=np.float64)
    np.add.at(total, idx, inst.count)
    minor_void = is_major_void & (cnt <= 0.5 * np.maximum(total, 1))
    if not minor_void.any():
        return obj, cnt, y

    pair_void = (inst.y < 0) | (inst.y >= num_classes)
    rows_nv = best(np.where(pair_void, -1, inst.count))
    # clusters whose best non-void row is itself void have no non-void
    # overlap at all: leave them on their void major
    nv_ok = ~pair_void[rows_nv]
    tgt = idx[rows_nv][nv_ok & minor_void[idx[rows_nv]]]
    src = rows_nv[nv_ok & minor_void[idx[rows_nv]]]
    obj[tgt] = inst.obj[src]
    cnt[tgt] = inst.count[src]
    y[tgt] = inst.y[src]
    return obj, cnt, y


def instance_graph_affinity(inst: InstanceData, edge_index,
                            num_classes=None, smooth_affinity=True):
    """Target affinity per (trimmed) edge, in the smooth
    formulation `(overlap_i_objj/size_i + overlap_j_obji/size_j)/2`."""
    ei, _ = to_trimmed_np(np.asarray(edge_index, dtype=np.int64))
    if ei.shape[1] == 0:
        return ei, np.zeros(0, dtype=np.float32)
    sp_obj, _, _ = instance_major(inst, num_classes=num_classes)
    i_obj = sp_obj[ei[0]]
    j_obj = sp_obj[ei[1]]
    if not smooth_affinity:
        return ei, (i_obj == j_obj).astype(np.float32)
    # overlap lookup (cluster, obj) -> count via dict-free hashing
    base = int(inst.obj.max()) + 1 if inst.obj.size else 1
    idx = inst.to_super_index()
    A = idx * base + inst.obj
    lut_keys, lut_pos = np.unique(A, return_index=True)
    counts = inst.count[lut_pos].astype(np.float64)

    def overlap(cluster, objs):
        q = cluster * base + objs
        pos = np.searchsorted(lut_keys, q)
        pos = np.clip(pos, 0, lut_keys.shape[0] - 1)
        hit = lut_keys[pos] == q
        return np.where(hit & (objs >= 0), counts[pos], 0.0)

    sp_size = np.zeros(inst.num_groups, dtype=np.float64)
    np.add.at(sp_size, idx, inst.count)
    o_ij = overlap(ei[0], j_obj)
    o_ji = overlap(ei[1], i_obj)
    aff = (o_ij / np.maximum(sp_size[ei[0]], 1)
           + o_ji / np.maximum(sp_size[ei[1]], 1)) / 2
    return ei, aff.astype(np.float32)


def estimate_instance_centroid(inst: InstanceData, pos, mode='iou'):
    """Estimate each gt instance's centroid from the clusters
    overlapping it, weighted by IoU or size-ratio product. Returns
    (obj_pos [n_obj, 3], obj_ids [n_obj] sorted)."""
    idx = inst.to_super_index()
    sp_size = np.zeros(inst.num_groups, dtype=np.float64)
    np.add.at(sp_size, idx, inst.count)
    objs, obj_inv = np.unique(inst.obj, return_inverse=True)
    obj_size = np.zeros(objs.shape[0], dtype=np.float64)
    np.add.at(obj_size, obj_inv, inst.count)
    c = inst.count.astype(np.float64)
    if mode == 'iou':
        w = c / (sp_size[idx] + obj_size[obj_inv] - c)
    else:  # 'ratio-product'
        w = (c / sp_size[idx]) * (c / obj_size[obj_inv])
    acc = np.zeros((objs.shape[0], pos.shape[1]), dtype=np.float64)
    np.add.at(acc, obj_inv, pos[idx] * w[:, None])
    wsum = np.zeros(objs.shape[0], dtype=np.float64)
    np.add.at(wsum, obj_inv, w)
    return (acc / np.maximum(wsum[:, None], 1e-12)).astype(np.float32), \
        objs


def instance_iou_and_size(inst: InstanceData,
                          pair_cropped_count=None):
    """IoU + set sizes per cluster-object pair. Returns
    (iou [M], a_size [M] cluster size, b_size [M] object size); if
    `pair_cropped_count` is given (produced by `remove_void`), it is
    added to b_size to account for object parts cropped with removed
    void predictions."""
    a_idx = inst.to_super_index()
    b_idx = np.unique(inst.obj, return_inverse=True)[1]
    a_size = np.bincount(a_idx, weights=inst.count)[a_idx]
    b_size = np.bincount(b_idx, weights=inst.count)[b_idx]
    if pair_cropped_count is not None:
        b_size = b_size + pair_cropped_count
    iou = inst.count / (a_size + b_size - inst.count)
    return iou, a_size, b_size


def instance_search_void(inst: InstanceData, num_classes):
    """Void masks per arXiv 1801.00868 / 1905.01220. Returns
    (is_cluster_void [Nc] — clusters with >50% void points,
     is_pair_void [M] — pairs whose object is void OR whose cluster is
     void, pair_cropped_count [M] — object size cropped by removing
     void clusters, for IoU correction)."""
    pair_b_void = (inst.y < 0) | (inst.y >= num_classes)
    a_idx = inst.to_super_index()
    n = inst.num_groups
    a_size = np.bincount(a_idx, weights=inst.count, minlength=n)
    void_size = np.bincount(a_idx[pair_b_void],
                            weights=inst.count[pair_b_void],
                            minlength=n)
    is_a_void = void_size > 0.5 * np.maximum(a_size, 1e-12)
    b_idx = np.unique(inst.obj, return_inverse=True)[1]
    cropped = np.bincount(b_idx,
                          weights=inst.count * is_a_void[a_idx])[b_idx]
    is_pair_void = pair_b_void | is_a_void[a_idx]
    return is_a_void, is_pair_void, cropped


def instance_remove_void(inst: InstanceData, num_classes):
    """New InstanceData with void clusters/objects/pairs removed.
    Returns (instance_data with `pair_cropped_count` set,
    non_void_mask over the original clusters)."""
    is_a_void, is_pair_void, cropped = instance_search_void(
        inst, num_classes)
    keep = ~is_pair_void
    idx = inst.to_super_index()[keep]
    # compact the cluster ids of the surviving pairs
    idx = np.unique(idx, return_inverse=True)[1]
    n_new = int(idx.max()) + 1 if idx.size else 0
    order = np.argsort(idx, kind='stable')
    ptr = np.zeros(n_new + 1, dtype=np.int64)
    np.cumsum(np.bincount(idx, minlength=n_new), out=ptr[1:])
    out = InstanceData(ptr, inst.obj[keep][order],
                       inst.count[keep][order], inst.y[keep][order])
    out.pair_cropped_count = cropped[keep][order]
    # NB: the surviving-cluster mask is NOT simply ~is_a_void: a
    # non-void cluster can lose all its pairs (all its objects void)
    # and disappear from the compacted indexing
    survives = np.zeros(inst.num_groups, dtype=bool)
    survives[inst.to_super_index()[keep]] = True
    return out, survives
