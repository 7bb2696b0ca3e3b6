"""Superedge construction on the host: a copy of the functions of the
JAX package's `ops/subedges.py` that `radius_horizontal_graph` runs,
with the per-edge anchor and subedge searches in the native library
(`ops/native.py`):

  1. candidate segment pairs: KNN over segment bbox centers with a
     conservative search radius, pruned by bbox radii, refined by
     iterative anchor nearest-neighbor search, kept if the anchor
     distance is within `gap`;
  2. subedges: for each segment pair, the point pairs that make it up
     (native/subedges.cpp);
  3. features: per-edge mean offset, std of offsets in a basis built
     around the mean offset, and sqrt of the mean subedge distance.
"""
import numpy as np

from .graph import to_trimmed_np
from .native import anchor_nn, subedges_pairs

__all__ = [
    'base_vectors_3d_np', 'scatter_nearest_neighbor_np',
    'cluster_radius_nn_graph_np', 'subedges_np',
    'minimalistic_edge_features_np', 'largest_eig3_np',
]


def base_vectors_3d_np(x):
    """Orthonormal basis per 3D vector: first axis along x, the other
    two span the orthogonal plane."""
    x = np.asarray(x, dtype=np.float64)
    a = x.copy()
    n = np.linalg.norm(a, axis=1)
    a[n == 0] = [1.0, 0.0, 0.0]
    a /= np.linalg.norm(a, axis=1, keepdims=True)
    b = np.stack([a[:, 1] - a[:, 2], a[:, 2] - a[:, 0],
                  a[:, 0] - a[:, 1]], axis=1)
    nb = np.linalg.norm(b, axis=1)
    b[nb == 0] = [2.0, 1.0, -1.0]
    # re-orthogonalize the fallback rows against a
    b -= (b * a).sum(1, keepdims=True) * a
    b /= np.linalg.norm(b, axis=1, keepdims=True)
    c = np.cross(a, b)
    return np.stack([a, b, c], axis=1)  # [N, 3 (basis), 3 (xyz)]


def _segment_csr(index, num_segments):
    """(order, ptr): point ids grouped by segment + CSR pointers."""
    order = np.argsort(index, kind='stable')
    counts = np.bincount(index, minlength=num_segments)
    ptr = np.zeros(num_segments + 1, dtype=np.int64)
    np.cumsum(counts, out=ptr[1:])
    return order, ptr


def scatter_nearest_neighbor_np(points, index, edge_index, cycles=3,
                                csr=None):
    """Approximate closest point pair ("anchors") per segment pair.
    Returns [2, E] point ids."""
    if edge_index.shape[1] == 0:
        return np.zeros((2, 0), dtype=np.int64)
    order, ptr = csr if csr is not None else _segment_csr(
        index, int(index.max()) + 1)
    return anchor_nn(points, order, ptr, edge_index, cycles=cycles)


def cluster_radius_nn_graph_np(points, index, k_max=100, gap=0.0,
                               cycles=3, csr=None):
    """Segment pairs with any two points within `gap`. Returns trimmed
    (i<j) [2, E] edge_index and the per-edge anchor distance."""
    from scipy.spatial import cKDTree

    num_segments = int(index.max()) + 1
    order, ptr = csr if csr is not None else _segment_csr(
        index, num_segments)
    pts_sorted = points[order]
    bbox_low = np.minimum.reduceat(pts_sorted, ptr[:-1], axis=0)
    bbox_high = np.maximum.reduceat(pts_sorted, ptr[:-1], axis=0)
    diam = (bbox_high - bbox_low).max(axis=1)
    center = (bbox_high + bbox_low) / 2

    r_search = float(diam.max() + gap)
    k = min(k_max + 1, num_segments)
    dist, nbr = cKDTree(center).query(
        center, k=k, distance_upper_bound=r_search)
    nbr = nbr[:, 1:]  # drop self
    dist = dist[:, 1:]
    src = np.repeat(np.arange(num_segments), nbr.shape[1])
    dst = nbr.reshape(-1)
    dd = dist.reshape(-1)
    valid = dst < num_segments  # cKDTree pads misses with n
    src, dst, dd = src[valid], dst[valid], dd[valid]

    # prune by actual segment radii (+ sqrt(3)*gap corner case)
    r_seg = diam / 2
    keep = dd <= r_seg[src] + r_seg[dst] + 1.7320508 * gap
    src, dst = src[keep], dst[keep]

    ei, _ = to_trimmed_np(np.stack([src, dst]))
    if ei.shape[1] == 0:
        return ei, np.zeros(0)

    anchors = scatter_nearest_neighbor_np(
        points, index, ei, cycles=cycles, csr=(order, ptr))
    d_nn = np.linalg.norm(points[anchors[0]] - points[anchors[1]],
                          axis=1)
    in_gap = d_nn <= gap
    return ei[:, in_gap], d_nn[in_gap]


def subedges_np(points, index, edge_index, ratio=0.2, k_min=20,
                cycles=3, margin=0.2, halfspace_filter=True,
                bbox_filter=True, target_pc_flip=True,
                source_pc_sort=False, csr=None):
    """Level-0 point pairs making up each segment-pair edge. Returns
    (trimmed edge_index [2, E], ST point-id pairs [2, M], uid [M])."""
    num_segments = int(index.max()) + 1
    order, ptr = csr if csr is not None else _segment_csr(
        index, num_segments)
    edge_index, _ = to_trimmed_np(edge_index)
    if edge_index.shape[1] == 0:
        return edge_index, np.zeros((2, 0), dtype=np.int64), \
            np.zeros(0, dtype=np.int64)
    pairs, uid = subedges_pairs(
        points, order, ptr, edge_index, ratio=ratio, k_min=k_min,
        cycles=cycles, margin=margin, halfspace_filter=halfspace_filter,
        bbox_filter=bbox_filter, target_pc_flip=target_pc_flip,
        source_pc_sort=source_pc_sort)
    return edge_index, pairs, uid


def minimalistic_edge_features_np(points, se_point_index, se_id,
                                  num_edges, unbiased=True):
    """[mean_off(3) | std_off(3) | sqrt(mean_dist)(1)] per trimmed edge.
    std_off is computed in a basis built around the mean offset and
    clipped to [-2, 2]."""
    offset = points[se_point_index[1]] - points[se_point_index[0]]
    dist = np.linalg.norm(offset, axis=1)
    cnt = np.maximum(
        np.bincount(se_id, minlength=num_edges), 1).astype(np.float64)

    def gmean(v):
        out = np.stack(
            [np.bincount(se_id, weights=v[:, c], minlength=num_edges)
             for c in range(v.shape[1])], axis=1)
        return out / cnt[:, None]

    mean_off = gmean(offset)
    base = base_vectors_3d_np(mean_off)  # [E, 3, 3]
    proj = np.einsum('nd,nbd->nb', offset, base[se_id])
    dev = (proj - gmean(proj)[se_id]) ** 2
    denom = np.maximum(cnt - 1, 1) if unbiased else cnt
    var = np.stack(
        [np.bincount(se_id, weights=dev[:, c], minlength=num_edges)
         for c in range(3)], axis=1) / denom[:, None]
    std_off = np.clip(np.sqrt(var), -2, 2)
    mean_dist = np.sqrt(
        np.bincount(se_id, weights=dist, minlength=num_edges) / cnt)
    return np.concatenate(
        [mean_off, std_off, mean_dist[:, None]], axis=1
    ).astype(np.float32)


def largest_eig3_np(cov):
    """Unit eigenvector of the largest eigenvalue of each symmetric 3x3
    matrix of `cov` [E, 3, 3], in float64: the closed-form trigonometric
    eigenvalue, then the cross product of the two rows of (C - lam I)
    with the largest cross norm. Its sign makes the entry of largest
    magnitude positive, the convention of the native twin
    (native/subedges.cpp), where np.linalg.eigh leaves signs to the
    implementation. A degenerate matrix gives (1, 0, 0)."""
    c = np.asarray(cov, dtype=np.float64)
    E = c.shape[0]
    c00, c11, c22 = c[:, 0, 0], c[:, 1, 1], c[:, 2, 2]
    c01, c02, c12 = c[:, 0, 1], c[:, 0, 2], c[:, 1, 2]
    p1 = c01 ** 2 + c02 ** 2 + c12 ** 2
    q = (c00 + c11 + c22) / 3.0
    p2 = (c00 - q) ** 2 + (c11 - q) ** 2 + (c22 - q) ** 2 + 2.0 * p1
    p = np.sqrt(np.maximum(p2 / 6.0, 0.0))
    safe_p = np.where(p > 0, p, 1.0)
    b = (c - q[:, None, None] * np.eye(3)) / safe_p[:, None, None]
    detb = (b[:, 0, 0] * (b[:, 1, 1] * b[:, 2, 2] - b[:, 1, 2] ** 2)
            - b[:, 0, 1] * (b[:, 0, 1] * b[:, 2, 2]
                            - b[:, 1, 2] * b[:, 0, 2])
            + b[:, 0, 2] * (b[:, 0, 1] * b[:, 1, 2]
                            - b[:, 1, 1] * b[:, 0, 2]))
    r = np.clip(detb / 2.0, -1.0, 1.0)
    lam = q + 2.0 * p * np.cos(np.arccos(r) / 3.0)
    a = c - lam[:, None, None] * np.eye(3)
    cr = np.stack([np.cross(a[:, 0], a[:, 1]),
                   np.cross(a[:, 0], a[:, 2]),
                   np.cross(a[:, 1], a[:, 2])], axis=1)  # [E, 3, 3]
    norms = np.einsum('eij,eij->ei', cr, cr)
    best = np.argmax(norms, axis=1)
    v = cr[np.arange(E), best]
    nv = np.sqrt(np.einsum('ei,ei->e', v, v))
    degenerate = (nv <= 1e-30) | (p2 <= 0)
    v = np.where(degenerate[:, None], [1.0, 0.0, 0.0],
                 v / np.where(nv > 0, nv, 1.0)[:, None])
    pick = np.argmax(np.abs(v), axis=1)
    sgn = np.sign(v[np.arange(E), pick])
    sgn = np.where(sgn == 0, 1.0, sgn)
    return v * sgn[:, None]
