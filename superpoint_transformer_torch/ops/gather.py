"""Gather with a gather-based backward.

Counterpart of `superpoint_transformer_tpu/ops/gather.py`.
`table[nbr_idx]` differentiates to a scatter-add over the neighbor
indices: on CUDA either float atomics, which add in a varying order, or
the embedding backward's sort and segmented sums. With the transpose
neighbor table built at batch preparation (`PaddedLevel.nbr_in_idx` /
`nbr_in_mask`: for each node, the flattened [N*K] slots that reference
it) the backward is a dense gather and a masked sum over the incoming
slots, in a fixed order.
"""
import torch
import torch.nn.functional as F

from ..utils.profiling import annotate

__all__ = ['gather_rows_t']


class _GatherRowsT(torch.autograd.Function):

    @staticmethod
    def forward(ctx, table, nbr_idx, in_idx, in_mask):
        ctx.save_for_backward(in_idx, in_mask)
        return F.embedding(nbr_idx, table)

    @staticmethod
    def backward(ctx, g):
        in_idx, in_mask = ctx.saved_tensors
        N, K, C = g.shape
        with annotate('spt.gather'):
            inc = F.embedding(in_idx, g.reshape(N * K, C))  # [N, K_in, C]
            inc = inc * in_mask[..., None].to(inc.dtype)
            acc = torch.float32 if inc.dtype == torch.bfloat16 \
                else inc.dtype
            return inc.sum(1, dtype=acc).to(g.dtype), None, None, None


def gather_rows_t(table, nbr_idx, in_idx, in_mask):
    """`table[nbr_idx]` whose backward uses the transpose table.

    :param table: [N, C]
    :param nbr_idx: [N, K] int, rows to gather
    :param in_idx: [N, K_in] int, the flattened [N*K] slot ids whose
        `nbr_idx` entry is the row (padding points at slot 0)
    :param in_mask: [N, K_in] bool, slot validity
    :return: [N, K, C]; the gradient of `table` sums each row's incoming
        cotangents, in f32 for a bf16 table

    Forward and backward run in `spt.gather` spans.
    """
    with annotate('spt.gather'):
        return _GatherRowsT.apply(table, nbr_idx, in_idx, in_mask)
