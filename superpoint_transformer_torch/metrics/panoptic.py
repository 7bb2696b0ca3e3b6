"""PanopticQuality3D — PQ/SQ/RQ + PQ† (modified), thing/stuff splits,
precision/recall — from CSR overlap data, never building dense masks. A
numpy copy of the JAX package's `metrics/panoptic.py`.

Matching follows the panoptic-segmentation definition (Kirillov et
al., arXiv 1801.00868): a predicted and a ground-truth instance of the
same class match iff IoU > 0.5 (such matches are unique by
construction, so TP counting is a plain bincount over agreeing
pairs).
Void handling follows `InstanceData.remove_void`: predictions with
>50% void points and void targets are excluded, and object sizes are
corrected for the cropped void predictions at IoU time.

The accumulation is streaming: per-scene class-wise tp / iou_sum /
pred / gt counts add up exactly as a concatenate-then-compute would
(matches never cross scenes), so no InstanceData lists are retained
between updates.
"""
from dataclasses import dataclass
import numpy as np

__all__ = ['PanopticQuality3D', 'panoptic_quality_from_overlaps']


def _nanmean(x):
    return float(np.nanmean(x)) if np.isfinite(x).any() else float('nan')


def panoptic_quality_from_overlaps(
        pred_of_item, gt_of_item, count_of_item, pred_sem, gt_sem,
        num_classes, stuff_classes=()):
    """Per-class PQ statistics from flattened overlap triplets.

    :param pred_of_item: [M] predicted-instance id of each overlap
    :param gt_of_item: [M] ground-truth-instance id of each overlap
    :param count_of_item: [M] number of points in the overlap
    :param pred_sem: [n_pred] semantic label per predicted instance
    :param gt_sem: [n_gt] semantic label per gt instance (<0 or
        >= num_classes marks void)
    :return: dict with tp / iou_sum / iou_mod_sum / pred_count /
        gt_count / seen per class
    """
    pred_of_item = np.asarray(pred_of_item)
    gt_of_item = np.asarray(gt_of_item)
    count_of_item = np.asarray(count_of_item, dtype=np.float64)
    pred_sem = np.asarray(pred_sem)
    gt_sem = np.asarray(gt_sem)
    is_stuff = np.zeros(num_classes, dtype=bool)
    if len(stuff_classes):
        is_stuff[np.asarray(stuff_classes, dtype=np.int64)] = True

    n_pred = pred_sem.shape[0]
    pred_size = np.bincount(pred_of_item, weights=count_of_item,
                            minlength=n_pred)

    # ---- void removal (as InstanceData.remove_void) -----------------
    pair_gt_void = (gt_sem < 0) | (gt_sem >= num_classes)
    pair_gt_void = pair_gt_void[gt_of_item]
    void_size = np.bincount(pred_of_item[pair_gt_void],
                            weights=count_of_item[pair_gt_void],
                            minlength=n_pred)
    pred_void = void_size > 0.5 * np.maximum(pred_size, 1e-12)
    # object size cropped by removing void predictions
    n_gt = gt_sem.shape[0]
    cropped = np.bincount(gt_of_item,
                          weights=count_of_item * pred_void[
                              pred_of_item], minlength=n_gt)
    pair_void = pair_gt_void | pred_void[pred_of_item]

    keep = ~pair_void
    p_i, g_i, c_i = pred_of_item[keep], gt_of_item[keep], \
        count_of_item[keep]

    out = dict(
        tp=np.zeros(num_classes, dtype=np.int64),
        iou_sum=np.zeros(num_classes),
        iou_mod_sum=np.zeros(num_classes),
        pred_count=np.zeros(num_classes, dtype=np.int64),
        gt_count=np.zeros(num_classes, dtype=np.int64),
        seen=np.zeros(num_classes, dtype=bool))
    # class populations after void removal
    valid_pred = np.unique(p_i)
    ps = pred_sem[valid_pred]
    ps = ps[(ps >= 0) & (ps < num_classes)]
    out['pred_count'] += np.bincount(ps, minlength=num_classes)
    valid_gt = np.unique(g_i)
    gs = gt_sem[valid_gt]
    out['gt_count'] += np.bincount(gs, minlength=num_classes)
    out['seen'][np.unique(np.concatenate([ps, gs]))] = True
    if c_i.size == 0:
        return out

    # pair IoUs with void-crop-corrected sizes
    a_size = np.bincount(p_i, weights=c_i, minlength=n_pred)[p_i]
    b_size = np.bincount(g_i, weights=c_i, minlength=n_gt)[g_i] \
        + cropped[g_i]
    iou = c_i / (a_size + b_size - c_i)

    agree = pred_sem[p_i] == gt_sem[g_i]
    tp_pair = agree & (iou > 0.5)
    cls = gt_sem[g_i[tp_pair]]
    out['tp'] += np.bincount(cls, minlength=num_classes)
    out['iou_sum'] += np.bincount(cls, weights=iou[tp_pair],
                                  minlength=num_classes)
    # PQ† pairs: stuff classes keep ALL agreeing overlaps
    # (arXiv 1905.01220)
    mod_pair = agree & ((iou > 0.5) | is_stuff[gt_sem[g_i]])
    cls_m = gt_sem[g_i[mod_pair]]
    out['iou_mod_sum'] += np.bincount(cls_m, weights=iou[mod_pair],
                                      minlength=num_classes)
    return out


@dataclass
class PanopticQuality3D:
    """Accumulating PQ metric over scenes."""
    num_classes: int
    stuff_classes: tuple = ()
    ignore_unseen_classes: bool = True

    def __post_init__(self):
        self.reset()

    def reset(self):
        n = self.num_classes
        self.tp = np.zeros(n, dtype=np.int64)
        self.iou_sum = np.zeros(n)
        self.iou_mod_sum = np.zeros(n)
        self.pred_count = np.zeros(n, dtype=np.int64)
        self.gt_count = np.zeros(n, dtype=np.int64)
        self.seen = np.zeros(n, dtype=bool)

    # derived totals (kept as properties for backwards compatibility
    # with callers reading `.fp` / `.fn`)
    @property
    def fp(self):
        return self.pred_count - self.tp

    @property
    def fn(self):
        return self.gt_count - self.tp

    def update(self, pred_of_item, gt_of_item, count_of_item, pred_sem,
               gt_sem):
        stats = panoptic_quality_from_overlaps(
            pred_of_item, gt_of_item, count_of_item, pred_sem, gt_sem,
            self.num_classes, stuff_classes=self.stuff_classes)
        self.tp += stats['tp']
        self.iou_sum += stats['iou_sum']
        self.iou_mod_sum += stats['iou_mod_sum']
        self.pred_count += stats['pred_count']
        self.gt_count += stats['gt_count']
        self.seen |= stats['seen']

    def update_from_instance_data(self, pred_inst, pred_sem,
                                  num_classes=None):
        """Update from a predicted-instance InstanceData whose CSR rows
        are (pred instance -> gt instance overlaps); `pred_inst.y` is
        the per-overlap gt label."""
        gt_objs, gt_inv = np.unique(pred_inst.obj, return_inverse=True)
        gt_sem = np.full(gt_objs.shape[0], -1, dtype=np.int64)
        gt_sem[gt_inv] = pred_inst.y  # per-overlap gt label
        self.update(pred_inst.to_super_index(), gt_inv,
                    pred_inst.count, pred_sem, gt_sem)

    def compute(self):
        n = self.num_classes
        is_stuff = np.zeros(n, dtype=bool)
        if len(self.stuff_classes):
            is_stuff[np.asarray(self.stuff_classes, np.int64)] = True
        has_stuff = is_stuff.any()

        with np.errstate(divide='ignore', invalid='ignore'):
            precision = np.where(self.pred_count > 0,
                                 self.tp / np.maximum(self.pred_count,
                                                      1), 0.0)
            recall = np.where(self.gt_count > 0,
                              self.tp / np.maximum(self.gt_count, 1),
                              0.0)
            sq = np.where(self.tp > 0,
                          self.iou_sum / np.maximum(self.tp, 1), 0.0)
            pr = precision + recall
            rq = np.where(pr > 0, 2 * precision * recall
                          / np.maximum(pr, 1e-12), 0.0)
            pq = sq * rq
            if has_stuff:
                denom = (self.gt_count + self.pred_count) / 2.0
                denom = np.where(is_stuff, self.gt_count, denom)
                pq_mod = np.where(denom > 0, self.iou_mod_sum
                                  / np.maximum(denom, 1e-12), 0.0)
            else:
                pq_mod = pq.copy()

        unseen = ~self.seen
        default = np.nan if self.ignore_unseen_classes else 0.0
        for arr in (pq, sq, rq, pq_mod, precision, recall):
            arr[unseen] = default

        def pct(x):
            v = _nanmean(x)
            return v * 100 if np.isfinite(v) else 0.0

        out = dict(
            pq=pct(pq), sq=pct(sq), rq=pct(rq),
            pq_modified=pct(pq_mod),
            pq_thing=pct(pq[~is_stuff]), sq_thing=pct(sq[~is_stuff]),
            rq_thing=pct(rq[~is_stuff]),
            pq_stuff=pct(pq[is_stuff]) if has_stuff else float('nan'),
            sq_stuff=pct(sq[is_stuff]) if has_stuff else float('nan'),
            rq_stuff=pct(rq[is_stuff]) if has_stuff else float('nan'),
            pq_per_class=pq * 100, sq_per_class=sq * 100,
            rq_per_class=rq * 100, pq_modified_per_class=pq_mod * 100,
            precision_per_class=precision, recall_per_class=recall,
            mean_precision=_nanmean(precision),
            mean_recall=_nanmean(recall),
            tp_per_class=self.tp.copy(), fp_per_class=self.fp.copy(),
            fn_per_class=self.fn.copy(),
            precision=_nanmean(precision), present=self.seen.copy())
        return out
