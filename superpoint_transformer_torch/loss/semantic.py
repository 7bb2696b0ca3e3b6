"""Semantic segmentation losses over padded levels; counterpart of
`superpoint_transformer_tpu/loss/semantic.py`. `group` (a process group,
where JAX has `axis_name`) makes every loss the ratio of its numerator and
denominator summed over the ranks, so that a node-sharded batch
(`parallel/shard_nag.py`) gives the loss of the whole batch on every rank.

Conventions, as in the JAX package:
  - logits [N, C]; y_hist [N, C+1] where column C counts void points;
    padded rows carry zero histograms and a False node mask;
  - CE against the dominant label ignores void (ignore_index=C) and
    normalizes by the applied weights, as torch's CrossEntropyLoss does;
  - the histogram loss normalizes by the total histogram mass, void
    included;
  - class weights multiply the per-class terms.
"""
import torch
import torch.nn.functional as F

from ..parallel.collectives import all_reduce_sum

__all__ = ['ce_loss', 'ce_with_histogram', 'multi_stage_loss']


def _ratio(num, den, group):
    """num / den, each summed over the ranks of `group` when given."""
    if group is not None:
        num, den = all_reduce_sum(torch.stack([num, den.to(num.dtype)]),
                                  group)
    return num / den.clamp(min=1e-12)


def ce_loss(logits, y_hist, class_weight=None, node_mask=None, group=None):
    """CE against the dominant histogram label (the first stage of the
    'ce*' losses)."""
    C = logits.shape[1]
    y = y_hist.argmax(1)
    valid = y < C
    if node_mask is not None:
        valid = valid & node_mask
    y_safe = y.clamp(0, C - 1)
    nll = -F.log_softmax(logits, dim=1).gather(1, y_safe[:, None])[:, 0]
    if class_weight is not None:
        w = class_weight[y_safe] * valid
    else:
        w = valid.to(logits.dtype)
    return _ratio((nll * w).sum(), w.sum(), group)


def ce_with_histogram(logits, y_hist, class_weight=None, node_mask=None,
                      group=None):
    """Cross-entropy against the full label histogram (the reference's
    loss_with_target_histogram)."""
    C = logits.shape[1]
    y = y_hist[:, :C].to(logits.dtype)
    void = y_hist[:, C].to(logits.dtype)
    if node_mask is not None:
        m = node_mask.to(logits.dtype)
        y = y * m[:, None]
        void = void * m
    logp = F.log_softmax(logits, dim=1)
    if class_weight is not None:
        per = -(y * class_weight[None, :] * logp).sum()
    else:
        per = -(y * logp).sum()
    return _ratio(per, y.sum() + void.sum(), group)


def _dominant_hist_loss(logits, y_hist, class_weight, mask, group=None):
    """'wce': the histogram mass collapsed onto the dominant label."""
    y_dom = y_hist.argmax(1)
    mass = y_hist.sum(1)
    cols = torch.arange(y_hist.shape[1], device=y_hist.device)
    dom_hist = (cols[None, :] == y_dom[:, None]).to(y_hist.dtype) \
        * mass[:, None]
    return ce_with_histogram(logits, dom_hist, class_weight=class_weight,
                             node_mask=mask, group=group)


def multi_stage_loss(logits_list, y_hist_list, lambdas, loss_type='ce_kl',
                     class_weight=None, node_masks=None, group=None):
    """Weighted sum of per-level losses. loss_type in {'ce', 'wce', 'kl',
    'ce_kl', 'wce_kl'}; the '*_kl' variants use (weighted) CE on the
    first (level-1) stage and the histogram loss above it. With `group`
    each level's loss is a ratio of sums over the ranks."""
    node_masks = node_masks or [None] * len(logits_list)
    total = 0.0
    for i, (lam, logits, y_hist, mask) in enumerate(zip(
            lambdas, logits_list, y_hist_list, node_masks)):
        cw = class_weight if loss_type in ('wce', 'wce_kl') or \
            (loss_type == 'ce_kl' and class_weight is not None) else None
        if loss_type == 'ce':
            li = ce_loss(logits, y_hist, node_mask=mask, group=group)
        elif loss_type == 'wce' or (loss_type == 'wce_kl' and i == 0):
            li = _dominant_hist_loss(logits, y_hist, class_weight, mask,
                                     group=group)
        elif loss_type == 'kl' or (loss_type in ('ce_kl', 'wce_kl')
                                   and i > 0):
            li = ce_with_histogram(logits, y_hist, class_weight=cw,
                                   node_mask=mask, group=group)
        elif loss_type == 'ce_kl':
            li = ce_loss(logits, y_hist, class_weight=cw, node_mask=mask,
                         group=group)
        else:
            raise ValueError(f'Unknown loss_type {loss_type}')
        total = total + lam * li
    return total
