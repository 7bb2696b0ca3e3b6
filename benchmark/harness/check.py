"""The numbers that decide `correct`: the program's outputs against the
plain reference's. `limits/<cell>.json` gives the limit of each number
compared; the others are recorded beside them.

Serving: every answer of the window (a level-1 class a node, in the
NAG's row order) is read against the reference's float32 logits of its
batch, by the gap by which the reference's logit of the served class
lies below its best: the mean gap over the nodes of one graph (a tile
or a room) at the worst graph of any request (`pred_gap_graph`), the
mean gap over the nodes of the worst request (`pred_gap_mean`), and the
widest gap of all (`pred_gap_max`).

Training: the first three steps against the reference's three steps
from the same weights: the worst step's relative loss gap (`loss_gap`);
per parameter, the gap between the norms of the first gradient (the
program's worked out from AdamW's first moment after one step) over the
larger of the reference's norm of that leaf and of the median leaf, at
the worst leaf (`grad_gap`), the median leaf (`grad_gap_median`), and
the leaves at the 10th, 75th and 90th percentiles (`grad_gap_q10`,
`grad_gap_q75`, `grad_gap_q90`); the same of the norms of the
parameters' change over the three steps (`change_gap`, `change_gap_q10`)
over the leaves whose reference gradient is at least a thousandth of the
median leaf's (the others move under Adam by round-off alone).
"""
import math

import numpy as np
import torch

__all__ = ['serve_numbers', 'train_numbers', 'judge', 'GRAD_FLOOR']

GRAD_FLOOR = 1e-3


def serve_numbers(ref_logits, graphs, answers):
    """`ref_logits`: {pool index: [n1, C] float32 numpy logits in NAG
    order}; `graphs`: {pool index: [n1] graph of each node, in NAG
    order}; `answers`: [(pool index, [n1] int predictions)]. Returns
    ({name: value}, number of answers that were malformed)."""
    gap_max, gap_mean, gap_graph, bad = 0.0, 0.0, 0.0, 0
    best = {b: z.max(1) for b, z in ref_logits.items()}
    for b, pred in answers:
        z = ref_logits[b]
        pred = np.asarray(pred)
        if pred.shape != (z.shape[0],) or pred.min() < 0 \
                or pred.max() >= z.shape[1]:
            bad += 1
            continue
        gap = best[b] - z[np.arange(z.shape[0]), pred]
        g = graphs[b]
        per_graph = np.bincount(g, weights=gap) / np.maximum(
            np.bincount(g), 1)
        gap_max = max(gap_max, float(gap.max()))
        gap_mean = max(gap_mean, float(gap.mean()))
        gap_graph = max(gap_graph, float(per_graph.max()))
    return {'pred_gap_max': gap_max, 'pred_gap_mean': gap_mean,
            'pred_gap_graph': gap_graph}, bad


def _norms(d):
    return {k: float(torch.linalg.vector_norm(v.double())) for k, v in
            d.items()}


def _gaps(got, ref, keys):
    """Each leaf's gap of norms over the larger of its reference norm and
    the median leaf's."""
    med = float(np.median([ref[k] for k in keys]))
    return [abs(got[k] - ref[k]) / max(ref[k], med, 1e-30) for k in keys]


def train_numbers(losses, grads, deltas, ref_losses, ref_grads,
                  ref_deltas):
    """The training numbers from the program's and the reference's
    losses of steps 1-3, first gradients and changes after step 3
    ({name: tensor} each)."""
    gaps = [abs(a - b) / max(abs(b), 1e-30) if math.isfinite(a)
            else math.inf for a, b in zip(losses, ref_losses)]
    g, gr = _norms(grads), _norms(ref_grads)
    d, dr = _norms(deltas), _norms(ref_deltas)
    keys = list(gr)
    med = float(np.median([gr[k] for k in keys]))
    moved = [k for k in keys if gr[k] >= GRAD_FLOOR * med]
    gg, cg = _gaps(g, gr, keys), _gaps(d, dr, moved)
    return {'loss_gap': max(gaps), 'grad_gap': max(gg),
            'grad_gap_median': float(np.median(gg)),
            'grad_gap_q10': float(np.quantile(gg, 0.1)),
            'grad_gap_q75': float(np.quantile(gg, 0.75)),
            'grad_gap_q90': float(np.quantile(gg, 0.9)),
            'change_gap': max(cg), 'change_gap_q10': float(np.quantile(cg, 0.1))}


def judge(numbers, limits):
    """({name: {'value', 'limit'}} of the numbers that have a limit, each
    of them within it). A number that is not finite fails; the numbers
    without a limit are recorded and not compared."""
    out, ok = {}, True
    for name, limit in limits.items():
        value = numbers[name]
        out[name] = {'value': value, 'limit': limit}
        ok = ok and math.isfinite(value) and value <= limit
    return out, ok
