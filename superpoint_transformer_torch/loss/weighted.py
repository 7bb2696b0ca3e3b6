"""Item-weighted regression and BCE losses (reference
src/loss/weighted.py:4 WeightedLossMixIn, src/loss/bce.py:10,
src/loss/l2.py, l1.py); counterpart of
`superpoint_transformer_tpu/loss/weighted.py`.

Each loss sums over the feature dimension, then takes the
weight-normalized mean over items (as the reference MixIn does), with an
optional validity mask for padded rows.
"""
import torch
import torch.nn.functional as F

__all__ = ['weighted_l2_loss', 'weighted_l1_loss',
           'weighted_bce_with_logits_loss']


def _weighted_mean(per_item, weight, mask):
    if mask is not None:
        m = mask.to(per_item.dtype)
        weight = m if weight is None else weight * m
    if weight is None:
        return per_item.mean()
    return (per_item * (weight / weight.sum().clamp(min=1e-12))).sum()


def _per_item(per):
    return per.sum(-1) if per.ndim > 1 else per


def weighted_l2_loss(input, target, weight=None, mask=None):
    return _weighted_mean(_per_item((input - target) ** 2), weight, mask)


def weighted_l1_loss(input, target, weight=None, mask=None):
    return _weighted_mean(_per_item((input - target).abs()), weight, mask)


def weighted_bce_with_logits_loss(logits, target, weight=None,
                                  pos_weight=None, mask=None):
    """BCE with logits, numerically stable, item-weighted (reference
    WeightedBCEWithLogitsLoss, src/loss/bce.py:10). `pos_weight` scales
    the positive term as in torch's BCEWithLogitsLoss."""
    log_p = F.logsigmoid(logits)
    log_not_p = F.logsigmoid(-logits)
    pw = 1.0 if pos_weight is None else pos_weight
    per = -(pw * target * log_p + (1.0 - target) * log_not_p)
    return _weighted_mean(_per_item(per), weight, mask)
