"""Multi-class Lovasz-Softmax loss (reference src/loss/lovasz.py:8, after
Berman 2018) on padded inputs; counterpart of
`superpoint_transformer_tpu/loss/lovasz.py`.

Per class, the errors |fg - p_c| are sorted in descending order; the
Lovasz extension's gradient of the Jaccard loss is a cumulative-sum
expression, so the loss is a sort, a cumsum and a dot. The sort is
stable, as JAX's argsort is, so that tied errors (padded items carry zero
error and zero fg) keep their order and the gradient matches JAX's.
"""
import torch
import torch.nn.functional as F

__all__ = ['lovasz_softmax_loss']


def _lovasz_grad(gt_sorted):
    """Gradient of the Lovasz extension of the Jaccard loss with respect
    to the sorted errors (reference lovasz_gradient,
    src/loss/lovasz.py:178)."""
    gts = gt_sorted.sum(-1, keepdim=True)
    intersection = gts - gt_sorted.cumsum(-1)
    union = gts + (1.0 - gt_sorted).cumsum(-1)
    jaccard = 1.0 - intersection / union.clamp(min=1e-12)
    return torch.cat([jaccard[..., :1],
                      jaccard[..., 1:] - jaccard[..., :-1]], -1)


def lovasz_softmax_loss(logits, y, class_to_sum='present', mask=None,
                        class_weight=None):
    """logits [N, C], y [N] int labels, mask [N] bool. Returns the sum
    of the per-class Lovasz losses ('present' keeps the classes that
    appear among the valid items, as the reference default does)."""
    n, c = logits.shape
    valid = (y >= 0) & (y < c)
    if mask is not None:
        valid = valid & mask
    y_safe = y.clamp(0, c - 1).long()
    probas = F.softmax(logits, dim=-1)
    vf = valid.to(logits.dtype)[None, :]
    classes = torch.arange(c, device=logits.device)[:, None]
    fg = (y_safe[None, :] == classes).to(logits.dtype) * vf      # [C, N]
    errors = (fg - probas.T).abs() * vf                           # [C, N]
    errors_sorted, order = torch.sort(errors, dim=1, descending=True,
                                      stable=True)
    grad = _lovasz_grad(fg.gather(1, order))
    per_class = (errors_sorted * grad).sum(1)                     # [C]
    w = torch.ones(c, dtype=logits.dtype, device=logits.device) \
        if class_weight is None else torch.as_tensor(
            class_weight, dtype=logits.dtype, device=logits.device)
    if class_to_sum == 'present':
        w = w * (fg.sum(1) > 0).to(logits.dtype)
    return (per_class * w).sum()
