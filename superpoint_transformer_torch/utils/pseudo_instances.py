"""Pseudo ground-truth instances for geometry without instance labels;
counterpart of `superpoint_transformer_tpu/utils/pseudo_instances.py`.

A preprocessed room may carry semantic label histograms but no
InstanceData (S3DIS instance annotations are not shipped with the
reference's demo NAG). Connected components of same-majority-label
level-0 voxels are the standard proxy: an object of a room is a
spatially connected segment of one class. These pseudo-instances let the
SuperCluster loop (affinity supervision, instance cut pursuit, PQ grid
search; reference src/models/panoptic.py:443-1051) run and be scored on
any NAG.
"""
import numpy as np

from ..data.csr import InstanceData
from ..ops.components import wcc_by_max_propagation_np
from ..ops.native import radius_knn

__all__ = ['add_pseudo_instances']


def add_pseudo_instances(nag, k=10, radius=0.35, min_size=4,
                         num_classes=13):
    """Attach pseudo InstanceData to `nag` levels 0 and 1.

    1. the majority label of each level-0 voxel (void where its
       histogram is empty);
    2. kNN adjacency over the voxel positions, keeping the edges whose
       endpoints share a (non-void) label;
    3. weakly connected components of that graph are the instances;
    4. components of fewer than `min_size` voxels become void (tiny
       speckles would flood PQ's instance count);
    5. InstanceData at level 0 (one overlap per voxel), merged to level
       1 through `super_index`. Void voxels share one void instance of
       label `num_classes`, so the InstanceData stays total.

    Returns (nag, info dict). The overlap count of a voxel is its label
    histogram's mass, so overlaps count raw points as the reference's
    do."""
    d0 = nag[0]
    counts = np.asarray(d0.y)[:, :num_classes].astype(np.int64)
    tot = counts.sum(1)
    major = counts.argmax(1)
    void = tot == 0

    pos = np.asarray(d0.pos)
    nbr, _ = radius_knn(pos, r=radius, k=k, exclude_self=True)
    src = np.repeat(np.arange(pos.shape[0]), nbr.shape[1])
    dst = nbr.reshape(-1)
    ok = dst >= 0
    src, dst = src[ok], dst[ok]
    same = (major[src] == major[dst]) & ~void[src] & ~void[dst]
    ei = np.stack([src[same], dst[same]])

    comp, _ = wcc_by_max_propagation_np(pos.shape[0], ei)
    # void voxels must not bridge components: they take no id here
    _, comp_dense = np.unique(comp[~void], return_inverse=True)
    inst = np.full(pos.shape[0], -1, dtype=np.int64)
    inst[~void] = comp_dense

    # instance size in voxels; tiny speckles become void
    n_inst = int(inst.max()) + 1 if (inst >= 0).any() else 0
    tiny = np.bincount(inst[inst >= 0], minlength=n_inst) < min_size
    if tiny.any():
        inst = np.where((inst >= 0) & tiny[np.clip(inst, 0, None)], -1,
                        inst)
        keep_ids, inst_dense = np.unique(inst[inst >= 0],
                                         return_inverse=True)
        inst[inst >= 0] = inst_dense
        n_inst = len(keep_ids)

    void_rows = inst < 0
    obj = np.where(void_rows, n_inst, inst)   # one shared void object
    y_obj = np.full(n_inst + 1, num_classes, dtype=np.int64)
    for c in range(num_classes):
        sel = ~void_rows & (major == c)
        if sel.any():
            y_obj[np.unique(obj[sel])] = c

    count = np.maximum(tot, 1).astype(np.int64)
    ptr0 = np.arange(pos.shape[0] + 1, dtype=np.int64)
    inst0 = InstanceData(ptr0, obj, count, y_obj[obj])
    d0['obj'] = inst0
    nag[1]['obj'] = inst0.merge(np.asarray(d0.super_index, dtype=np.int64))

    info = {
        'n_instances': int(n_inst),
        'n_void_voxels': int(void_rows.sum()),
        'mean_instance_voxels': float(
            np.bincount(inst[inst >= 0]).mean()) if n_inst else 0.0,
        'classes_present': sorted(
            int(c) for c in np.unique(major[~void_rows])),
    }
    return nag, info
