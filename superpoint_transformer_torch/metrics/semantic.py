"""Confusion-matrix semantic metrics; counterparts of
`confusion_matrix_from_histogram`, `ConfusionMatrix` and the
`*_from_confmat` functions in `superpoint_transformer_tpu/metrics/
semantic.py`. Rows are targets, columns predictions; void labels never
enter the matrix. The device function works on tensors; the accumulator
and the metrics are numpy on the host, as in JAX."""
from dataclasses import dataclass

import numpy as np
import torch

__all__ = ['confusion_matrix_from_histogram', 'ConfusionMatrix',
           'iou_from_confmat', 'oa_from_confmat', 'macc_from_confmat',
           'miou_from_confmat']


def confusion_matrix_from_histogram(pred, y_hist, num_classes,
                                    node_mask=None):
    """cm[target, pred] += y_hist[n, target] over the rows n, as an int64
    [C, C] tensor. `pred` is [N] class ids or [N, C] logits (argmax).
    The counts are summed in f32, exact below 2^24 per cell."""
    y = y_hist[:, :num_classes].to(torch.float32)
    if node_mask is not None:
        y = y * node_mask[:, None].to(y.dtype)
    if pred.dim() == 2:
        pred = pred.argmax(1)
    cm = torch.zeros((num_classes, num_classes), dtype=torch.float32,
                     device=y.device)
    # float atomics, yet reproducible: every summand is an integer and
    # every partial sum stays below 2^24, so each addition is exact
    cm.index_add_(1, pred, y.t())
    return cm.round().to(torch.int64)


def iou_from_confmat(cm):
    """Per-class IoU (in %) and the present-class mask."""
    cm = np.asarray(cm, dtype=np.float64)
    tp = np.diag(cm)
    fn = cm.sum(1) - tp
    fp = cm.sum(0) - tp
    denom = tp + fp + fn
    present = cm.sum(1) > 0
    iou = np.divide(tp, denom, out=np.zeros_like(tp), where=denom > 0)
    return iou * 100, present


def oa_from_confmat(cm):
    cm = np.asarray(cm, dtype=np.float64)
    total = cm.sum()
    return float(np.diag(cm).sum() / total * 100) if total > 0 else 0.0


def macc_from_confmat(cm):
    cm = np.asarray(cm, dtype=np.float64)
    row = cm.sum(1)
    present = row > 0
    if present.sum() == 0:
        return 0.0
    acc = np.divide(np.diag(cm), row, out=np.zeros_like(row),
                    where=present)
    return float(acc[present].mean() * 100)


def miou_from_confmat(cm, missing_as_one=False):
    iou, present = iou_from_confmat(cm)
    if present.sum() == 0:
        return 0.0
    if missing_as_one:
        iou = np.where(present, iou, 100.0)
        return float(iou.mean())
    return float(iou[present].mean())


@dataclass
class ConfusionMatrix:
    """Host-side int64 accumulator of one stage's confusion matrix."""
    num_classes: int

    def __post_init__(self):
        self.reset()

    def reset(self):
        self.confmat = np.zeros(
            (self.num_classes, self.num_classes), dtype=np.int64)

    def update(self, pred, target, node_mask=None):
        """Add rows: `pred` [N] class ids or [N, C] logits; `target`
        [N, >=C] label histograms or [N] labels (void ones skipped)."""
        pred = np.asarray(pred)
        target = np.asarray(target)
        if pred.ndim == 2:
            pred = pred.argmax(1)
        c = self.num_classes
        if target.ndim == 2 and target.shape[1] >= c:
            y = target[:, :c].astype(np.float64)
            if node_mask is not None:
                y = y * np.asarray(node_mask)[:, None]
            cm = np.zeros((c, c), np.float64)
            np.add.at(cm.T, pred, y)
            self.confmat += np.rint(cm).astype(np.int64)
            return
        y = target.reshape(-1)
        valid = (y >= 0) & (y < c)
        if node_mask is not None:
            valid &= np.asarray(node_mask, bool)
        self.confmat += np.bincount(
            y[valid] * c + pred[valid], minlength=c * c).reshape(c, c)

    def merge(self, cm_array):
        self.confmat += np.asarray(cm_array, dtype=np.int64)

    def miou(self, **kw):
        return miou_from_confmat(self.confmat, **kw)

    def oa(self):
        return oa_from_confmat(self.confmat)

    def macc(self):
        return macc_from_confmat(self.confmat)

    def iou(self):
        return iou_from_confmat(self.confmat)

    def all_metrics(self):
        iou, present = self.iou()
        return dict(oa=self.oa(), macc=self.macc(), miou=self.miou(),
                    iou_per_class=iou, present=present)
