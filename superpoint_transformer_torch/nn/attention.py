"""SelfAttentionBlock over dense padded neighbors.

Counterpart of `superpoint_transformer_tpu/nn/attention.py` for the
flagship RPE set (independent k/q/v encoders of the edge features): qkv
projection in the compute dtype, one gather of the neighbors' joint k/v
rows (in training, with the transpose neighbor table when the batch
carries it: `ops/gather.py:gather_rows_t`), attention, `out_proj` in the
compute dtype, output in f32. The attention takes the JAX package's
routes:

- evaluation: the streaming RPE attention kernel K2
  (`ops/attention_rpe.py`), which computes the RPE projections itself;
- training: the three RPE projections as one concatenated matmul added to
  the gathered rows, a query per edge, and the dense attention kernel K1
  with its closed-form backward (`ops/attention.py`).

The other RPE variants run K1 at inference too in the JAX package; they
are not ported.

Under graph-partition sharding (`shard_group`, `parallel/shard_nag.py`)
`nbr_idx` holds global slots (`rank * capacity + local slot`): the ranks'
joint k/v rows are gathered into one global table
(`parallel/collectives.py:all_gather_rows`), from which each rank gathers
its neighbors. JAX gathers the k and the v table in two collectives; one
collective of the joint rows gives the same values. The transpose
neighbor table is rank-local, so it is dropped there, as in JAX, and the
training gather is `gather_rows`.
"""
import torch
import torch.nn.functional as F
from torch import nn

from ..ops.attention import (dense_attention_reference,
                             dense_attention_trainable)
from ..ops.attention_rpe import (dense_attention_rpe,
                                 dense_attention_rpe_reference)
from ..ops.gather import gather_rows_t
from ..ops.segment import gather_rows
from ..parallel.collectives import all_gather_rows
from .mlp import linear, resolve_dtype

__all__ = ['SelfAttentionBlock', 'qk_scale_from_degree']


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

    `plain_attention=True` runs the plain PyTorch versions of the kernels
    on every device (autograd through the plain forward in training); it
    exists to compare the kernels with them. Attention dropout and
    residual dropout accept only None or 0: no config sets them."""

    def __init__(self, dim, num_heads=1, qkv_bias=True, qk_dim=8,
                 qk_scale=None, in_rpe_dim=18, k_rpe=False, q_rpe=False,
                 v_rpe=False, qk_share_rpe=False, q_on_minus_rpe=False,
                 heads_share_rpe=False, attn_drop=None, drop=None,
                 compute_dtype=None, plain_attention=False,
                 shard_group=None, device=None):
        super().__init__()
        if not (k_rpe and q_rpe and v_rpe) or qk_share_rpe \
                or q_on_minus_rpe or heads_share_rpe:
            raise NotImplementedError(
                'SelfAttentionBlock: only independent k/q/v RPE is '
                'ported; the JAX package runs this RPE variant on the '
                'dense attention kernel K1 at inference too')
        for name, rate in (('attn_drop', attn_drop), ('drop', drop)):
            if rate:
                raise NotImplementedError(
                    f'SelfAttentionBlock: {name}={rate} is not ported')
        H, D, C = num_heads, qk_dim, dim
        self.num_heads, self.qk_dim, self.dim = H, D, C
        self.qk_scale = qk_scale
        self.dtype = resolve_dtype(compute_dtype)
        self.plain_attention = plain_attention
        self.shard_group = shard_group
        self.qkv = nn.Linear(C, 2 * H * D + C, bias=qkv_bias,
                             device=device)
        self.k_rpe = nn.Linear(in_rpe_dim, H * D, device=device)
        self.q_rpe = nn.Linear(in_rpe_dim, H * D, device=device)
        self.v_rpe = nn.Linear(in_rpe_dim, C, device=device)
        self.out_proj = nn.Linear(C, C, device=device)

    def forward(self, x, nbr_idx, nbr_mask, edge_feat=None,
                nbr_in_idx=None, nbr_in_mask=None):
        """
        :param x: [N, C] node features
        :param nbr_idx: [N, K] neighbor node ids (padded slots: 0)
        :param nbr_mask: [N, K] slot validity
        :param edge_feat: [N, K, De] edge features for the RPE
        :param nbr_in_idx, nbr_in_mask: [N, K_in] transpose neighbor
            table; in training the k/v gather's backward runs over it
        :return: [N, C] f32
        """
        if edge_feat is None:
            raise NotImplementedError(
                'SelfAttentionBlock without edge features is not ported '
                '(the JAX package runs it on the dense attention kernel '
                'K1 in both modes)')
        N, K = nbr_idx.shape
        C, H, D = self.dim, self.num_heads, self.qk_dim
        DH, dt = H * D, self.dtype
        qkv = linear(self.qkv, x, dt)
        q = qkv[:, :DH].reshape(N, H, D).contiguous()
        kv = qkv[:, DH:]
        if self.shard_group is not None:
            kv = all_gather_rows(kv, self.shard_group)
            nbr_in_idx = None
        # one gather of the joint k/v rows
        if self.training and nbr_in_idx is not None:
            kvg = gather_rows_t(kv, nbr_idx, nbr_in_idx,
                                nbr_in_mask)               # [N, K, DH+C]
        else:
            kvg = gather_rows(kv, nbr_idx)
        scale = qk_scale_from_degree(self.qk_scale, D, nbr_mask.sum(1))
        edge_feat = edge_feat.to(dt)
        rpe = (self.k_rpe, self.q_rpe, self.v_rpe)

        if self.training:
            # the three RPE projections as one [N*K, De] @ [De, 2*DH + C]
            # matmul, added to the gathered rows
            w_cat = torch.cat([m.weight for m in rpe]).to(dt)
            b_cat = torch.cat([m.bias for m in rpe]).to(dt)
            r = F.linear(edge_feat, w_cat, b_cat)          # [N, K, 2DH+C]
            k = (kvg[..., :DH] + r[..., :DH]).reshape(N, K, H, D)
            q = q[:, None] + r[..., DH:2 * DH].reshape(N, K, H, D)
            v = (kvg[..., DH:] + r[..., 2 * DH:]).reshape(N, K, H, C // H)
            attention = dense_attention_reference if self.plain_attention \
                else dense_attention_trainable
            out = attention(q, k, v, nbr_mask, scale)
        else:
            attention = dense_attention_rpe_reference \
                if self.plain_attention else dense_attention_rpe
            out = attention(
                q, kvg[..., :DH], kvg[..., DH:], edge_feat,
                *(t for m in rpe
                  for t in (m.weight.to(dt).t().contiguous(), m.bias)),
                nbr_mask, scale)
        out = linear(self.out_proj, out.reshape(N, C), dt)
        return out.to(torch.float32)
