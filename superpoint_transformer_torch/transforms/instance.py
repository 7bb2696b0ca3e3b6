"""The instance graph of SuperCluster, on the host (numpy): a copy of the
JAX package's `transforms/instance.py`. Builds the level-1
`obj_edge_index` graph and its target affinities.
"""
import numpy as np

from ..ops.native import radius_knn
from ..ops.graph import to_trimmed_np
from ..ops.instance import (
    instance_graph_affinity, instance_major, estimate_instance_centroid)

__all__ = ['on_the_fly_instance_graph']


def on_the_fly_instance_graph(
        nag, level=1, num_classes=None, k_max=30, radius=1.0,
        adjacency_mode='radius-centroid', smooth_affinity=True):
    """Build the instance graph at `level`.

    'available': the level's horizontal graph.
    'radius-centroid': neighbors by superpoint centroid distance.
    'radius-atomic': two superpoints are adjacent if any of their
    points are within `radius`.
    """
    if level is None or level < 0:
        return nag
    d = nag[level]
    n = d.num_nodes

    if adjacency_mode == 'available':
        ei = d.edge_index
    elif adjacency_mode == 'radius-atomic':
        if level == nag.start_i_level:
            # nano NAGs have no atomic level below: the nodes are
            # their own atoms (degenerates to the centroid graph)
            sup = np.arange(n, dtype=np.int64)
        else:
            sup = nag.get_super_index(level, low=nag.start_i_level)
        pts = nag[nag.start_i_level].pos
        nbr, _ = radius_knn(pts, r=radius, k=k_max, exclude_self=True)
        src = np.repeat(np.arange(pts.shape[0]), nbr.shape[1])
        dst = nbr.reshape(-1)
        ok = dst >= 0
        ss, tt = sup[src[ok]], sup[dst[ok]]
        cross = ss != tt
        ei = np.unique(
            np.stack([ss[cross], tt[cross]]), axis=1) \
            if cross.any() else np.zeros((2, 0), dtype=np.int64)
    else:  # radius-centroid
        nbr, _ = radius_knn(d.pos, r=radius, k=k_max,
                            exclude_self=True)
        src = np.repeat(np.arange(n), nbr.shape[1])
        dst = nbr.reshape(-1)
        ok = dst >= 0
        ei = np.stack([src[ok], dst[ok]])

    obj = d.get('obj')
    if obj is None:
        d['obj_edge_index'], _ = to_trimmed_np(
            np.asarray(ei, dtype=np.int64))
        return nag

    oei, aff = instance_graph_affinity(
        obj, ei, num_classes=num_classes,
        smooth_affinity=smooth_affinity)
    d['obj_edge_index'] = oei
    d['obj_edge_affinity'] = aff

    # target instance centroid per superpoint (for a node-offset head,
    # which no config enables)
    obj_pos, obj_ids = estimate_instance_centroid(obj, d.pos)
    sp_obj, _, _ = instance_major(obj, num_classes=num_classes)
    lut = {int(o): i for i, o in enumerate(obj_ids)}
    rows = np.asarray([lut.get(int(o), 0) for o in sp_obj])
    d['obj_pos'] = obj_pos[rows]
    return nag
