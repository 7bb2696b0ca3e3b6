"""Weighted L1/L2 error metrics (reference src/metrics/weighted_li.py
WeightedL2Error / WeightedL1Error, the torchmetrics accumulators that
track node-offset regression); counterpart of
`superpoint_transformer_tpu/metrics/weighted_li.py`.

Accumulators on the host over (sum of weighted errors, sum of weights),
in float64. `update` takes numpy arrays or tensors on any device.
"""
from dataclasses import dataclass, field

import numpy as np
import torch

__all__ = ['WeightedL1Error', 'WeightedL2Error']


def _f64(a):
    if torch.is_tensor(a):
        a = a.detach().cpu().double().numpy()
    return np.asarray(a, np.float64)


@dataclass
class _WeightedError:
    order: int = 2

    def __post_init__(self):
        self.reset()

    def reset(self):
        self.total = 0.0
        self.weight = 0.0

    def update(self, pred, target, weight=None):
        err = np.abs(_f64(pred) - _f64(target)) ** self.order
        if err.ndim > 1:
            err = err.sum(-1)
        w = np.ones(err.shape[0]) if weight is None \
            else _f64(weight).reshape(-1)
        self.total += float((err * w).sum())
        self.weight += float(w.sum())

    def compute(self):
        return self.total / max(self.weight, 1e-12)


@dataclass
class WeightedL1Error(_WeightedError):
    order: int = field(default=1)


@dataclass
class WeightedL2Error(_WeightedError):
    order: int = field(default=2)
