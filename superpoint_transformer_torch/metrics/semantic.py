"""Confusion matrix from label histograms; counterpart of
`confusion_matrix_from_histogram` in
`superpoint_transformer_tpu/metrics/semantic.py`. Rows are targets,
columns predictions; void labels never enter the matrix."""
import torch

__all__ = ['confusion_matrix_from_histogram']


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
    cm.index_add_(1, pred, y.t())
    return cm.round().to(torch.int64)
