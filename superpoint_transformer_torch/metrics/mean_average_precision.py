"""MeanAveragePrecision3D — COCO-style instance-segmentation mAP/mAR
computed from CSR overlaps, never building dense masks: a numpy copy of
the JAX package's `metrics/mean_average_precision.py` (the pycocotools
evaluation protocol).

Predictions and targets are partitions of the scene: every point
belongs to exactly one predicted and one ground-truth instance, so a
pred-gt IoU is derived from overlap counts alone:
    IoU = count / (size_pred + size_gt - count).

Void handling (the remove_void convention, arXiv:1801.00868): void
ground-truth instances are ignored; unmatched predictions with > 50%
void overlap are discarded rather than counted as false positives.
"""
from dataclasses import dataclass
from typing import Dict, Optional, Sequence

import numpy as np

__all__ = ['MeanAveragePrecision3D', 'average_precision']

_DEFAULT_IOU_THRESHOLDS = np.round(np.arange(0.5, 1.0, 0.05), 2)
_DEFAULT_REC_THRESHOLDS = np.linspace(0., 1., 101)


def average_precision(scores, is_tp, n_gt, rec_thresholds):
    """COCO 101-point interpolated AP for one (class, IoU threshold).

    :param scores: [P] prediction confidences
    :param is_tp: [P] bool, whether each prediction matched a gt
    :param n_gt: number of ground-truth instances
    """
    if n_gt == 0:
        return np.nan, np.nan
    if scores.shape[0] == 0:
        return 0.0, 0.0
    order = np.argsort(-scores, kind='stable')
    tp = is_tp[order].astype(np.float64)
    fp = 1.0 - tp
    tp_cum = np.cumsum(tp)
    fp_cum = np.cumsum(fp)
    recall = tp_cum / n_gt
    precision = tp_cum / np.maximum(tp_cum + fp_cum, 1e-12)
    # monotone non-increasing interpolated precision
    precision = np.maximum.accumulate(precision[::-1])[::-1]
    # sample at recall thresholds
    idx = np.searchsorted(recall, rec_thresholds, side='left')
    prec_at = np.where(idx < precision.shape[0],
                       precision[np.minimum(idx, precision.shape[0] - 1)],
                       0.0)
    ap = float(prec_at.mean())
    ar = float(recall[-1])
    return ap, ar


@dataclass
class MeanAveragePrecision3D:
    """Accumulating instance-segmentation mAP over scenes."""
    num_classes: int
    iou_thresholds: Optional[Sequence[float]] = None
    rec_thresholds: Optional[Sequence[float]] = None
    stuff_classes: Sequence[int] = ()
    min_size: int = 0
    class_metrics: bool = True

    def __post_init__(self):
        self._extra = (0.25,) if self.iou_thresholds is None else ()
        self.iou_thresholds = np.asarray(
            _DEFAULT_IOU_THRESHOLDS if self.iou_thresholds is None
            else self.iou_thresholds, dtype=np.float64)
        self.rec_thresholds = np.asarray(
            _DEFAULT_REC_THRESHOLDS if self.rec_thresholds is None
            else self.rec_thresholds, dtype=np.float64)
        self.reset()

    def reset(self):
        # per class: list of (score, [(gt_uid, iou), ...]) predictions
        self._preds: Dict[int, list] = {
            c: [] for c in range(self.num_classes)}
        self._n_gt = np.zeros(self.num_classes, dtype=np.int64)
        self._scene = 0

    # -- update ----------------------------------------------------------
    def update(self, pred_of_item, gt_of_item, count_of_item, pred_sem,
               pred_score, gt_sem):
        """Add one scene from flattened overlap triplets (same layout
        as PanopticQuality3D.update).

        :param pred_of_item: [M] predicted-instance id per overlap
        :param gt_of_item: [M] gt-instance id per overlap
        :param count_of_item: [M] overlap point count
        :param pred_sem: [P] predicted class per instance
        :param pred_score: [P] confidence per predicted instance
        :param gt_sem: [G] gt class per instance (void = outside
            [0, num_classes))
        """
        pred_of_item = np.asarray(pred_of_item)
        gt_of_item = np.asarray(gt_of_item)
        count = np.asarray(count_of_item, dtype=np.float64)
        pred_sem = np.asarray(pred_sem)
        pred_score = np.asarray(pred_score, dtype=np.float64)
        gt_sem = np.asarray(gt_sem)
        n_pred, n_gt = pred_sem.shape[0], gt_sem.shape[0]

        pred_size = np.zeros(n_pred)
        np.add.at(pred_size, pred_of_item, count)
        gt_size = np.zeros(n_gt)
        np.add.at(gt_size, gt_of_item, count)

        gt_void = (gt_sem < 0) | (gt_sem >= self.num_classes)
        gt_small = gt_size < self.min_size
        gt_eval = ~gt_void & ~gt_small
        stuff = set(int(s) for s in self.stuff_classes)

        # gt uid namespace is per-scene
        gt_uid = gt_of_item + self._scene * (n_gt + 1)

        void_overlap = np.zeros(n_pred)
        if gt_void.any():
            vo = gt_void[gt_of_item]
            np.add.at(void_overlap, pred_of_item[vo], count[vo])
        small_overlap = np.zeros(n_pred)
        if gt_small.any():
            so = gt_small[gt_of_item] & ~gt_void[gt_of_item]
            np.add.at(small_overlap, pred_of_item[so], count[so])

        iou = count / np.maximum(
            pred_size[pred_of_item] + gt_size[gt_of_item] - count, 1e-12)
        same_class = pred_sem[pred_of_item] == gt_sem[gt_of_item]

        by_pred: Dict[int, list] = {p: [] for p in range(n_pred)}
        keep = same_class & gt_eval[gt_of_item]
        for m in np.where(keep)[0]:
            by_pred[int(pred_of_item[m])].append(
                (int(gt_uid[m]), float(iou[m])))

        for p in range(n_pred):
            c = int(pred_sem[p])
            if c < 0 or c >= self.num_classes or c in stuff:
                continue
            if pred_size[p] <= 0:
                continue
            # drop predictions dominated by void / undersized gt
            if (void_overlap[p] + small_overlap[p]) / pred_size[p] > 0.5:
                continue
            self._preds[c].append((float(pred_score[p]), by_pred[p]))

        for g in np.where(gt_eval)[0]:
            c = int(gt_sem[g])
            if c not in stuff:
                self._n_gt[c] += 1
        self._scene += 1

    def update_from_instance_data(self, pred_inst, pred_sem, pred_score):
        """Update from a predicted-instance InstanceData whose CSR rows
        are (pred instance -> gt instance overlaps) — the framework's
        native layout (see PanopticQuality3D.update_from_instance_data).
        """
        gt_objs, gt_inv = np.unique(pred_inst.obj, return_inverse=True)
        gt_sem = np.full(gt_objs.shape[0], -1, dtype=np.int64)
        gt_sem[gt_inv] = pred_inst.y
        self.update(pred_inst.to_super_index(), gt_inv, pred_inst.count,
                    pred_sem, pred_score, gt_sem)

    # -- compute ---------------------------------------------------------
    def _ap_for(self, c, thr):
        preds = self._preds[c]
        scores = np.array([s for s, _ in preds])
        order = np.argsort(-scores, kind='stable')
        matched = set()
        is_tp = np.zeros(len(preds), dtype=bool)
        for rank in order:
            _, cands = preds[rank]
            best_iou, best_gt = thr, None
            for gt, i in cands:
                if i >= best_iou and gt not in matched:
                    best_iou, best_gt = i, gt
            if best_gt is not None:
                matched.add(best_gt)
                is_tp[rank] = True
        return average_precision(
            scores, is_tp, int(self._n_gt[c]), self.rec_thresholds)

    def compute(self):
        thrs = list(self.iou_thresholds)
        stuff = set(int(s) for s in self.stuff_classes)
        classes = [c for c in range(self.num_classes) if c not in stuff]
        ap = np.full((len(classes), len(thrs)), np.nan)
        ar = np.full((len(classes), len(thrs)), np.nan)
        for ci, c in enumerate(classes):
            for ti, t in enumerate(thrs):
                ap[ci, ti], ar[ci, ti] = self._ap_for(c, t)

        def nanmean(a):
            return float(np.nanmean(a)) if np.isfinite(a).any() else np.nan

        def at(t):
            if t in thrs:
                return nanmean(ap[:, thrs.index(t)])
            ap25 = np.full(len(classes), np.nan)
            for ci, c in enumerate(classes):
                ap25[ci], _ = self._ap_for(c, t)
            return nanmean(ap25)

        out = {
            'map': nanmean(ap),
            'map_25': at(0.25),
            'map_50': at(0.5) if 0.5 in thrs else np.nan,
            'map_75': at(0.75) if 0.75 in thrs else np.nan,
            'mar': nanmean(ar),
        }
        if self.class_metrics:
            out['map_per_class'] = np.nanmean(ap, axis=1) \
                if ap.size else np.zeros(0)
            out['mar_per_class'] = np.nanmean(ar, axis=1) \
                if ar.size else np.zeros(0)
            out['classes'] = np.asarray(classes)
        return out
