"""EZ-SP's partition criterion: a contrastive edge-affinity loss on point
embeddings. Counterpart of `superpoint_transformer_tpu/loss/
partition_criterion.py`.

Each adjacency edge (i, j) predicts the affinity exp(-||x_i - x_j|| / T);
its target is 1 where the majority labels of i and j agree (an intra
edge) and 0 across a boundary (an inter edge); the loss is a binary
focal loss. The intra edges are reweighted rather than subsampled: every
inter edge weighs 1 and each intra edge n_inter (1/ratio - 1) / n_intra,
clipped to [0, 1], which keeps the sampled class proportions of the
reference in expectation with static shapes.
"""
import torch

from ..ops.segment import gather_rows

__all__ = ['partition_criterion', 'edge_affinity_from_features',
           'INTER_EDGE_LABEL', 'INTRA_EDGE_LABEL']

INTER_EDGE_LABEL = 0
INTRA_EDGE_LABEL = 1


def edge_affinity_from_features(x, edge_index, temperature=1.0):
    """exp(-||x_i - x_j|| / T) per edge [E]; the distance is
    sqrt(max(||.||^2, 1e-20)), so that its gradient stays finite."""
    diff = gather_rows(x, edge_index[0]) - gather_rows(x, edge_index[1])
    d = torch.sqrt(torch.clamp((diff * diff).sum(-1), min=1e-20))
    return torch.exp(-d / temperature)


def partition_criterion(
        x, y_hist, edge_index, edge_mask=None, num_classes=None,
        affinity_temperature=1.0, adaptive_sampling_ratio=0.9,
        gamma=1.0, focal_weight=0.5, train=True):
    """(loss, aux) for embeddings `x` [N, D], label histograms `y_hist`
    [N, C(+1)] (a last void column), `edge_index` [2, E] and its mask.
    Self-loops and edges touching a voxel of void labels only are left
    out; the loss is 0 where no inter edge is left. aux holds
    n_inter_edge, n_valid_edge, predicted_affinity, target_affinity and
    edge_valid, as tensors on the device of `x`."""
    C = num_classes if num_classes is not None else y_hist.shape[1] - 1
    counts = y_hist[:, :C]
    majority_count = counts.max(dim=1).values
    y_major = counts.argmax(dim=1)

    src, dst = edge_index[0], edge_index[1]
    valid = torch.ones(src.shape[0], dtype=torch.bool, device=x.device) \
        if edge_mask is None else edge_mask.bool()
    valid = valid & (src != dst)
    void = majority_count == 0
    valid = valid & ~void[src] & ~void[dst]

    target = (y_major[src] == y_major[dst]).to(torch.int32)
    is_inter = (target == INTER_EDGE_LABEL) & valid
    is_intra = (target == INTRA_EDGE_LABEL) & valid
    n_inter = is_inter.sum()
    n_intra = is_intra.sum()

    weight = valid.to(torch.float32)
    if train and adaptive_sampling_ratio is not None:
        n_keep_intra = n_inter.to(torch.float32) * (
            1.0 / float(adaptive_sampling_ratio) - 1.0)
        rate = torch.clamp(
            n_keep_intra / torch.clamp(n_intra.to(torch.float32), min=1.0),
            0.0, 1.0)
        weight = torch.where(is_intra, rate, weight)

    pred = edge_affinity_from_features(
        x, edge_index, temperature=affinity_temperature)
    yb = target.to(torch.float32)
    p_t = (1.0 - yb) + pred * (2.0 * yb - 1.0)
    eps = 1e-6
    p_t = eps + (1.0 - 2.0 * eps) * p_t
    cw = yb * focal_weight + (1.0 - yb) * (1.0 - focal_weight)
    per = -((1.0 - p_t) ** gamma) * torch.log(p_t) * cw * weight
    denom = torch.clamp(weight.sum(), min=1.0)
    loss = torch.where(n_inter > 0, per.sum() / denom,
                       torch.zeros((), dtype=per.dtype, device=x.device))
    aux = {
        'n_inter_edge': n_inter,
        'n_valid_edge': valid.sum(),
        'predicted_affinity': pred,
        'target_affinity': target,
        'edge_valid': valid,
    }
    return loss, aux
