"""SelfAttentionBlock over dense padded neighbors, inference path.

Counterpart of `superpoint_transformer_tpu/nn/attention.py` for the
flagship RPE set (independent k/q/v encoders of the edge features):
qkv projection in the compute dtype, one gather of the neighbors' k/v
rows, the streaming RPE attention kernel (`ops/attention_rpe.py`),
`out_proj` in the compute dtype, output in f32. Training and the other
RPE variants need the plain attention kernel (K1,
`dense_attention_pallas`), which is not ported yet.
"""
import torch
from torch import nn

from ..ops.attention_rpe import (dense_attention_rpe,
                                 dense_attention_rpe_reference)
from .mlp import linear, resolve_dtype

__all__ = ['SelfAttentionBlock', 'qk_scale_from_degree']

_NEEDS_K1 = ('needs the dense attention kernel K1 '
             '(dense_attention_pallas), which is not ported yet')


def qk_scale_from_degree(mode, qk_dim, degree):
    """Softmax temperature 1/sqrt(qk_dim) * 1/sqrt(degree), the 'd.g'
    mode every config uses (qk_scale None); degree [N] is the number of
    valid neighbor slots, clamped at 1."""
    if mode not in (None, 'd.g', 'dg', 'gd', 'd*g', 'g*d', 'g.d'):
        raise NotImplementedError(f'qk_scale {mode!r}: only d.g is ported')
    g = degree.to(torch.float32).clamp(min=1.0) ** -0.5
    return float(qk_dim) ** -0.5 * g


class SelfAttentionBlock(nn.Module):
    """Multi-head self-attention of each node over its K neighbor slots,
    with k/q/v relative position encodings of the edge features.

    `plain_attention=True` runs the plain PyTorch version of the kernel
    on every device; it exists to compare the kernel with it."""

    def __init__(self, dim, num_heads=1, qkv_bias=True, qk_dim=8,
                 qk_scale=None, in_rpe_dim=18, k_rpe=False, q_rpe=False,
                 v_rpe=False, qk_share_rpe=False, q_on_minus_rpe=False,
                 heads_share_rpe=False, compute_dtype=None,
                 plain_attention=False, device=None):
        super().__init__()
        if not (k_rpe and q_rpe and v_rpe) or qk_share_rpe \
                or q_on_minus_rpe or heads_share_rpe:
            raise NotImplementedError(
                'SelfAttentionBlock: only independent k/q/v RPE is '
                f'ported; this RPE variant {_NEEDS_K1}')
        H, D, C = num_heads, qk_dim, dim
        self.num_heads, self.qk_dim, self.dim = H, D, C
        self.qk_scale = qk_scale
        self.dtype = resolve_dtype(compute_dtype)
        self.plain_attention = plain_attention
        self.qkv = nn.Linear(C, 2 * H * D + C, bias=qkv_bias,
                             device=device)
        self.k_rpe = nn.Linear(in_rpe_dim, H * D, device=device)
        self.q_rpe = nn.Linear(in_rpe_dim, H * D, device=device)
        self.v_rpe = nn.Linear(in_rpe_dim, C, device=device)
        self.out_proj = nn.Linear(C, C, device=device)

    def forward(self, x, nbr_idx, nbr_mask, edge_feat=None):
        """
        :param x: [N, C] node features
        :param nbr_idx: [N, K] neighbor node ids (padded slots: 0)
        :param nbr_mask: [N, K] slot validity
        :param edge_feat: [N, K, De] edge features for the RPE
        :return: [N, C] f32
        """
        if self.training:
            raise NotImplementedError(f'SelfAttentionBlock training '
                                      f'{_NEEDS_K1}')
        if edge_feat is None:
            raise NotImplementedError(
                f'SelfAttentionBlock without edge features {_NEEDS_K1}')
        N, C = x.shape[0], self.dim
        H, D = self.num_heads, self.qk_dim
        DH, dt = H * D, self.dtype
        qkv = linear(self.qkv, x, dt)
        q = qkv[:, :DH].reshape(N, H, D).contiguous()
        # one gather of the joint k/v rows; the kernel reads the two
        # column blocks of the gathered table in place
        kvg = qkv[:, DH:][nbr_idx]                         # [N, K, DH+C]
        scale = qk_scale_from_degree(self.qk_scale, D, nbr_mask.sum(1))

        def w(layer):
            return layer.weight.to(dt).t().contiguous()

        attention = dense_attention_rpe_reference if self.plain_attention \
            else dense_attention_rpe
        out = attention(
            q, kvg[..., :DH], kvg[..., DH:], edge_feat.to(dt),
            w(self.k_rpe), self.k_rpe.bias, w(self.q_rpe), self.q_rpe.bias,
            w(self.v_rpe), self.v_rpe.bias, nbr_mask, scale)
        out = linear(self.out_proj, out.reshape(N, C), dt)
        return out.to(torch.float32)
