"""Partition oracles: the best metrics a perfect classifier could reach on
a given superpoint partition (each superpoint predicts its majority, or
its dominant ground-truth instance). A numpy copy of
`superpoint_transformer_tpu/metrics/oracle.py`, over the port's
`ConfusionMatrix`, `InstanceData`, `PanopticQuality3D` and
`MeanAveragePrecision3D`.
"""
import numpy as np

from .mean_average_precision import MeanAveragePrecision3D
from .panoptic import PanopticQuality3D
from .semantic import ConfusionMatrix

__all__ = ['semantic_segmentation_oracle', 'panoptic_segmentation_oracle',
           'instance_segmentation_oracle']


def semantic_segmentation_oracle(y_hist, num_classes):
    """Metrics when every node predicts its majority label, from label
    histograms `y_hist` [N, C(+void)]: dict(miou, oa, macc, confmat,
    ...)."""
    counts = np.asarray(y_hist)[:, :num_classes].astype(np.int64)
    major = counts.argmax(1)
    cm = ConfusionMatrix(num_classes)
    conf = np.zeros((num_classes, num_classes), np.int64)
    for c in range(num_classes):
        np.add.at(conf[c], major, counts[:, c])
    cm.merge(conf)
    out = cm.all_metrics()
    out['confmat'] = conf
    return out


def _dominant_instance(inst):
    """Per cluster: the ground-truth instance of largest overlap, its
    label, that overlap and the cluster's size."""
    sup = inst.to_super_index()
    n = inst.num_groups
    best = np.full(n, -1, np.int64)
    best_y = np.full(n, -1, np.int64)
    size = np.zeros(n, np.int64)
    np.add.at(size, sup, inst.count)
    # in increasing count order, so that the largest overlap writes last
    order = np.argsort(inst.count, kind='stable')
    best[sup[order]] = inst.obj[order]
    best_y[sup[order]] = inst.y[order]
    cnt = np.zeros(n, np.int64)
    np.maximum.at(cnt, sup, inst.count)
    return best, best_y, cnt, size


def _dominant_merge(inst):
    """The clusters merged by dominant instance, and each merged
    prediction's label."""
    best, best_y, _, _ = _dominant_instance(inst)
    uniq, pred_id = np.unique(best, return_inverse=True)
    pred_sem = np.full(uniq.shape[0], -1, np.int64)
    pred_sem[pred_id] = best_y
    return inst.merge(pred_id), pred_sem


def panoptic_segmentation_oracle(inst, num_classes, stuff_classes=()):
    """PQ when every cluster of `inst` (an `InstanceData`) is assigned its
    dominant ground-truth instance (clusters of one instance merge into
    one prediction): the `PanopticQuality3D.compute()` dict."""
    merged, pred_sem = _dominant_merge(inst)
    pq = PanopticQuality3D(num_classes, stuff_classes=stuff_classes)
    pq.update_from_instance_data(merged, pred_sem)
    return pq.compute()


def instance_segmentation_oracle(inst, num_classes, stuff_classes=()):
    """Instance-segmentation mAP under the same dominant-instance
    assignment: the `MeanAveragePrecision3D.compute()` dict."""
    merged, pred_sem = _dominant_merge(inst)
    m = MeanAveragePrecision3D(num_classes, stuff_classes=stuff_classes)
    m.update_from_instance_data(merged, pred_sem,
                                np.ones(pred_sem.shape[0]))
    return m.compute()
