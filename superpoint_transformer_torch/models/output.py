"""Prediction outputs: voxel- and full-resolution predictions recovered
from level-1 logits through the hierarchy's maps. Counterparts of
`SemanticSegmentationOutput` and `PanopticSegmentationOutput` in
`superpoint_transformer_tpu/models/output.py` (numpy, on the host)."""
from dataclasses import dataclass
from typing import Optional

import numpy as np

__all__ = ['SemanticSegmentationOutput', 'PanopticSegmentationOutput']


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
