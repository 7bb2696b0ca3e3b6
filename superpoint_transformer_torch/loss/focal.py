"""Focal losses (reference src/loss/focal.py:11,171); counterpart of
`superpoint_transformer_tpu/loss/focal.py`.

Plain functions on tensors, differentiable through autograd. They take
padded tensors and an optional validity mask instead of filtering items.
"""
import torch
import torch.nn.functional as F

__all__ = ['weighted_focal_loss', 'binary_focal_loss']


def weighted_focal_loss(logits, y, gamma=0.0, class_weight=None,
                        item_weight=None, mask=None):
    """Multi-class focal loss  -w_c (1 - p_t)^gamma log(p_t)
    (reference WeightedFocalLoss, src/loss/focal.py:11; gamma=0 reduces
    to weighted cross-entropy).

    logits [N, C]; y [N] int labels (negative: ignored); item_weight [N]
    per-item weights; mask [N] bool validity. The sum is normalized by
    the applied weights."""
    n, c = logits.shape
    valid = y >= 0
    if mask is not None:
        valid = valid & mask
    y_safe = y.clamp(0, c - 1).long()
    log_pt = F.log_softmax(logits, dim=-1).gather(1, y_safe[:, None])[:, 0]
    focal = (1.0 - log_pt.exp()) ** gamma
    cw = torch.ones(c, dtype=logits.dtype, device=logits.device) \
        if class_weight is None else torch.as_tensor(
            class_weight, dtype=logits.dtype, device=logits.device)
    w_item = cw[y_safe]
    if item_weight is not None:
        w_item = w_item * item_weight
    w_item = torch.where(valid, w_item, torch.zeros_like(w_item))
    per = -focal * log_pt * w_item
    return per.sum() / w_item.sum().clamp(min=1e-12)


def binary_focal_loss(p, y, gamma=0.0, weight=0.5, epsilon=1e-6,
                      mask=None):
    """Binary focal loss on PROBABILITIES (reference BinaryFocalLoss,
    src/loss/focal.py:171): p_t = p if y else 1-p, squeezed into
    [eps, 1-eps]; loss = -(1-p_t)^gamma log(p_t), weighted by `weight`
    for positives and `1-weight` for negatives, averaged over the valid
    items."""
    yf = y.to(p.dtype)
    p_t = (1.0 - yf) + p * (2.0 * yf - 1.0)
    p_t = epsilon + (1.0 - 2.0 * epsilon) * p_t
    w = yf * weight + (1.0 - yf) * (1.0 - weight)
    per = -((1.0 - p_t) ** gamma) * torch.log(p_t) * w
    if mask is None:
        return per.mean()
    m = mask.to(p.dtype)
    return (per * m).sum() / m.sum().clamp(min=1.0)
