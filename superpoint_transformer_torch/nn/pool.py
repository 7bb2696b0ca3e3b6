"""Child -> parent pooling (counterpart of `pool` in
`superpoint_transformer_tpu/nn/pool.py`, max mode)."""
import torch

from ..ops.segment import segment_max

__all__ = ['pool']


def pool(mode, x_child, index, num_parents, mask=None):
    """Max-pool children into parents. Padded children carry
    index == num_parents and are dropped; masked children take the
    -finfo.max sentinel; parents with no valid child come out as 0."""
    if mode != 'max':
        raise NotImplementedError(f'pool mode {mode!r}: only max is ported')
    big = torch.finfo(x_child.dtype).max
    xc = x_child if mask is None else torch.where(
        mask[:, None], x_child, torch.full_like(x_child, -big))
    out = segment_max(xc, index, num_parents)
    return torch.where(out <= -big * 0.5, torch.zeros_like(out), out)
