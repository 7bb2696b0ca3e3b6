"""Prediction outputs: voxel- and full-resolution predictions recovered
from level-1 logits through the hierarchy's maps, and the accumulation of
test-time augmentation (TTA) runs. Counterparts of
`SemanticSegmentationOutput`, `PanopticSegmentationOutput` and
`tta_accumulate` in `superpoint_transformer_tpu/models/output.py` (numpy,
on the host)."""
from dataclasses import dataclass
from typing import List, Optional

import numpy as np

from ..ops.native import radius_knn

__all__ = ['SemanticSegmentationOutput', 'PanopticSegmentationOutput',
           'tta_accumulate']


@dataclass
class SemanticSegmentationOutput:
    """Level-1 logits, with the maps that project them back to voxels
    (level 0) and to full-resolution points."""
    logits: np.ndarray                       # [N1, C] level-1 logits
    y_hist: Optional[np.ndarray] = None      # [N1, C+1] targets

    @property
    def semantic_pred(self):
        return np.argmax(self.logits, axis=1)

    def voxel_semantic_pred(self, super_index):
        """Level-1 predictions spread to the level-0 voxels through the
        parent map."""
        return self.semantic_pred[super_index]

    def full_res_semantic_pred(self, super_index, sub):
        """Full-resolution predictions: level 1 -> voxels -> raw points
        through the `sub` Cluster of level 0, in the raw cloud's order."""
        voxel_pred = self.voxel_semantic_pred(super_index)
        out = np.empty(sub.num_items, dtype=voxel_pred.dtype)
        out[sub.points] = np.repeat(voxel_pred, sub.sizes)
        return out


@dataclass
class PanopticSegmentationOutput(SemanticSegmentationOutput):
    obj_index: Optional[np.ndarray] = None   # [N1] predicted instance
    obj_sem: Optional[np.ndarray] = None     # per-instance class
    edge_affinity_logits: Optional[np.ndarray] = None

    def voxel_panoptic_pred(self, super_index):
        return (self.voxel_semantic_pred(super_index),
                self.obj_index[super_index])

    def full_res_panoptic_pred(self, super_index, sub):
        sem = self.full_res_semantic_pred(super_index, sub)
        voxel_obj = self.obj_index[super_index]
        obj = np.empty(sub.num_items, dtype=voxel_obj.dtype)
        obj[sub.points] = np.repeat(voxel_obj, sub.sizes)
        return sem, obj


def tta_accumulate(run_logits: List[np.ndarray],
                   run_node_ids: List[np.ndarray], num_nodes: int,
                   num_classes: int, pos=None, k_propagate=3):
    """Sum the logits of TTA runs by node id, in float64; a node that no
    run saw takes the mean of the accumulated logits of its
    `k_propagate` nearest seen nodes (by `pos`, the native `radius_knn`)
    (reference step_multi_run_inference, src/models/semantic.py:533-559).
    Without `pos`, or when no run saw any node, unseen rows stay zero.

    :param run_logits: per run [n_i, C] logits
    :param run_node_ids: per run [n_i] node ids in [0, num_nodes), each
        at most once a run
    :param pos: [num_nodes, 3] node positions
    :return: [num_nodes, C] float64
    """
    acc = np.zeros((num_nodes, num_classes), dtype=np.float64)
    seen = np.zeros(num_nodes, dtype=bool)
    for logits, ids in zip(run_logits, run_node_ids):
        np.add.at(acc, ids, logits)
        seen[ids] = True
    if (~seen).any() and pos is not None and seen.any():
        nbr, _ = radius_knn(pos[seen], pos[~seen], r=1e9,
                            k=min(k_propagate, seen.sum()),
                            exclude_self=False)
        seen_idx = np.where(seen)[0]
        fill = np.zeros(((~seen).sum(), num_classes))
        cnt = np.zeros((~seen).sum())
        for j in range(nbr.shape[1]):
            ok = nbr[:, j] >= 0
            fill[ok] += acc[seen_idx[nbr[ok, j]]]
            cnt[ok] += 1
        acc[~seen] = fill / np.maximum(cnt[:, None], 1)
    return acc
