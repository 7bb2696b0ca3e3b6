"""SelfAttentionBlock over dense padded neighbors.

Counterpart of `superpoint_transformer_tpu/nn/attention.py`: qkv
projection in the compute dtype, one gather of the neighbors' joint k/v
rows (in training, with the transpose neighbor table when the batch
carries it: `ops/gather.py:gather_rows_t`), the k/q/v relative position
encodings (RPE) of the edge features, attention, `out_proj` in the
compute dtype, output in f32, and the residual dropout `drop`. The
attention takes the JAX package's routes:

- independent k/q/v RPE (the flagship's), in evaluation: the streaming
  RPE attention kernel K2 (`ops/attention_rpe.py`), which computes the
  RPE projections itself; with `fused_rpe=False` (JAX's
  `set_pallas_attention(..., fused_rpe=False)`) the RPE materialized as
  in training, then K1's forward;
- independent k/q/v RPE in training: the three RPE projections as one
  concatenated matmul added to the gathered rows (each its own matmul
  with `fuse_rpe_matmul=False`), a query per edge, and the dense
  attention kernel K1 with its closed-form backward (`ops/attention.py`);
- any other RPE set (k, q or v alone or in pairs, `qk_share_rpe`,
  `q_on_minus_rpe`, `heads_share_rpe`), or no edge features: each RPE
  its own projection, then K1 in both modes, with a query per node when
  no q RPE is added and per edge otherwise;
- attention dropout (`attn_drop > 0`) in training: the plain attention
  with the dropout on the materialized weights, JAX's own XLA route (its
  kernels take no dropout). In evaluation such a model runs its kernel.

The parameters are JAX's: `k_rpe` / `q_rpe` project to H*D channels, or
to D shared by the heads with `heads_share_rpe`; `v_rpe` to C, or C/H;
under `qk_share_rpe` the queries reuse `k_rpe` and there is no `q_rpe`.
A block built with `in_rpe_dim=0` has no RPE parameters (the JAX block
makes them only when it sees edge features).

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

from ..ops.attention import (dense_attention, dense_attention_reference,
                             dense_attention_trainable)
from ..ops.attention_rpe import (dense_attention_rpe,
                                 dense_attention_rpe_reference)
from ..ops.gather import gather_rows_t
from ..ops.segment import gather_rows
from ..parallel.collectives import all_gather_rows
from .mlp import dropout, linear, resolve_dtype

__all__ = ['SelfAttentionBlock', 'qk_scale_from_degree',
           'set_pallas_attention']


def qk_scale_from_degree(mode, qk_dim, degree):
    """Softmax temperature per node from its degree [N] (the number of
    valid neighbor slots, clamped at 1), with D = 1/sqrt(qk_dim) and
    G = 1/sqrt(degree): 'd.g' (and None, every config's) D*G, 'd+g' D+G,
    'd' D, 'g' G, a number that number."""
    d = float(qk_dim) ** -0.5
    g = degree.to(torch.float32).clamp(min=1.0) ** -0.5
    if mode is None or mode in ('d.g', 'dg', 'gd', 'd*g', 'g*d', 'g.d'):
        return d * g
    if mode in ('d+g', 'g+d'):
        return d + g
    if mode == 'd':
        return torch.full_like(g, d)
    if mode == 'g':
        return g
    if isinstance(mode, (int, float)):
        return torch.full_like(g, float(mode))
    raise ValueError(f'unknown qk_scale {mode!r}')


def _materialized_attention(q, k, v, nbr_mask, scale, drop):
    """JAX's XLA attention with the weights materialized, for attention
    dropout in training: q*scale rounded to the dtype of q, the logits
    and the weighted sum accumulated in f32, the masked softmax, then
    `drop` on the weights. Returns [N, H, C/H] f32."""
    f32 = torch.float32
    if q.dim() == 3:
        qs = (q * scale[:, None, None]).to(q.dtype)
        logit = torch.einsum('nhd,nkhd->nkh', qs.to(f32), k.to(f32))
    else:
        qs = (q * scale[:, None, None, None]).to(q.dtype)
        logit = torch.einsum('nkhd,nkhd->nkh', qs.to(f32), k.to(f32))
    m3 = nbr_mask[:, :, None]
    logit = torch.where(m3, logit, torch.full_like(logit, -1e30))
    attn = torch.softmax(logit, dim=1) * m3.to(f32)
    attn = drop(attn)
    return torch.einsum('nkh,nkhc->nhc', attn.to(v.dtype).to(f32),
                        v.to(f32))


class SelfAttentionBlock(nn.Module):
    """Multi-head self-attention of each node over its K neighbor slots,
    with the relative position encodings of the edge features that
    `k_rpe`, `q_rpe`, `v_rpe`, `qk_share_rpe`, `q_on_minus_rpe` and
    `heads_share_rpe` select (see the module docstring for the routes).

    `plain_attention=True` runs the plain PyTorch versions of the kernels
    on every device (autograd through the plain forward in training); it
    exists to compare the kernels with them. `fused_rpe=False` serves the
    independent k/q/v RPE materialized, on K1's forward, instead of K2;
    `fuse_rpe_matmul=False` runs their three projections as three
    matmuls where they are materialized (JAX's A/B switches, both True by
    default as in JAX; `set_pallas_attention` sets them on a model).
    `attn_drop` drops attention weights and `drop` the block's output, in
    training, drawing from `rng` (`nn/dropout.py`)."""

    def __init__(self, dim, num_heads=1, qkv_bias=True, qk_dim=8,
                 qk_scale=None, in_rpe_dim=18, k_rpe=False, q_rpe=False,
                 v_rpe=False, qk_share_rpe=False, q_on_minus_rpe=False,
                 heads_share_rpe=False, attn_drop=None, drop=None,
                 compute_dtype=None, plain_attention=False,
                 fused_rpe=True, fuse_rpe_matmul=True, shard_group=None,
                 rng=None, device=None):
        super().__init__()
        H, D, C = num_heads, qk_dim, dim
        self.num_heads, self.qk_dim, self.dim = H, D, C
        self.qk_scale = qk_scale
        self.dtype = resolve_dtype(compute_dtype)
        self.plain_attention = plain_attention
        self.fused_rpe = fused_rpe
        self.fuse_rpe_matmul = fuse_rpe_matmul
        self.shard_group = shard_group
        self.qk_share_rpe = qk_share_rpe
        self.q_on_minus_rpe = q_on_minus_rpe
        self.heads_share_rpe = heads_share_rpe
        self.k_rpe_on, self.q_rpe_on, self.v_rpe_on = k_rpe, q_rpe, v_rpe
        # the flagship's independent k/q/v encoders: K2 in evaluation
        # (unless `fused_rpe` is off)
        self.independent_rpe = (k_rpe and q_rpe and v_rpe
                                and not qk_share_rpe and not q_on_minus_rpe
                                and not heads_share_rpe)
        self.qkv = nn.Linear(C, 2 * H * D + C, bias=qkv_bias,
                             device=device)
        rpe_dim = D if heads_share_rpe else H * D
        if in_rpe_dim:
            if k_rpe:
                self.k_rpe = nn.Linear(in_rpe_dim, rpe_dim, device=device)
            if q_rpe and not (k_rpe and qk_share_rpe):
                self.q_rpe = nn.Linear(in_rpe_dim, rpe_dim, device=device)
            if v_rpe:
                self.v_rpe = nn.Linear(
                    in_rpe_dim, C // H if heads_share_rpe else C,
                    device=device)
        self.out_proj = nn.Linear(C, C, device=device)
        self.attn_drop = dropout(attn_drop, rng)
        self.drop = dropout(drop, rng)

    def _heads(self, r, N, K, width):
        """An RPE [N, K, *] as [N, K, H, width], tiled over the heads
        under `heads_share_rpe` (JAX's `jnp.tile`)."""
        if self.heads_share_rpe:
            r = r.repeat(1, 1, self.num_heads)
        return r.reshape(N, K, self.num_heads, width)

    def _variant_terms(self, q, kvg, edge_feat, N, K):
        """k [N, K, H, D], q [N, H, D] or per edge [N, K, H, D] and
        v [N, K, H, C/H] with each RPE its own projection, as the JAX
        block adds them."""
        H, D, C, DH, dt = (self.num_heads, self.qk_dim, self.dim,
                           self.num_heads * self.qk_dim, self.dtype)
        k = kvg[..., :DH].reshape(N, K, H, D)
        v = kvg[..., DH:].reshape(N, K, H, C // H)
        if edge_feat is None:
            return q, k, v
        ef = edge_feat.to(dt)
        q_ef = -ef if self.q_on_minus_rpe else ef
        if hasattr(self, 'k_rpe'):
            k = k + self._heads(linear(self.k_rpe, ef, dt), N, K, D)
            if self.q_rpe_on and self.qk_share_rpe:
                q = q[:, None] + self._heads(linear(self.k_rpe, q_ef, dt),
                                             N, K, D)
        if hasattr(self, 'q_rpe'):
            q = q[:, None] + self._heads(linear(self.q_rpe, q_ef, dt), N, K,
                                         D)
        if hasattr(self, 'v_rpe'):
            v = v + self._heads(linear(self.v_rpe, ef, dt), N, K, C // H)
        return q, k, v

    def _flagship_terms(self, q, kvg, edge_feat, N, K):
        """The independent k/q/v RPE of JAX's materialized route: the three
        projections as one [N*K, De] @ [De, 2*DH + C] matmul added to the
        gathered rows, a query per edge."""
        H, D, C, DH, dt = (self.num_heads, self.qk_dim, self.dim,
                           self.num_heads * self.qk_dim, self.dtype)
        rpe = (self.k_rpe, self.q_rpe, self.v_rpe)
        w_cat = torch.cat([m.weight for m in rpe]).to(dt)
        b_cat = torch.cat([m.bias for m in rpe]).to(dt)
        r = F.linear(edge_feat.to(dt), w_cat, b_cat)       # [N, K, 2DH+C]
        k = (kvg[..., :DH] + r[..., :DH]).reshape(N, K, H, D)
        q = q[:, None] + r[..., DH:2 * DH].reshape(N, K, H, D)
        v = (kvg[..., DH:] + r[..., 2 * DH:]).reshape(N, K, H, C // H)
        return q, k, v

    def forward(self, x, nbr_idx, nbr_mask, edge_feat=None,
                nbr_in_idx=None, nbr_in_mask=None):
        """
        :param x: [N, C] node features
        :param nbr_idx: [N, K] neighbor node ids (padded slots: 0)
        :param nbr_mask: [N, K] slot validity
        :param edge_feat: [N, K, De] edge features for the RPE, or None
        :param nbr_in_idx, nbr_in_mask: [N, K_in] transpose neighbor
            table; in training the k/v gather's backward runs over it
        :return: [N, C] f32
        """
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
        flagship = (self.independent_rpe and edge_feat is not None
                    and hasattr(self, 'v_rpe'))

        if flagship and not self.training and self.fused_rpe:
            rpe = (self.k_rpe, self.q_rpe, self.v_rpe)
            attention = dense_attention_rpe_reference \
                if self.plain_attention else dense_attention_rpe
            out = attention(
                q, kvg[..., :DH], kvg[..., DH:], edge_feat.to(dt),
                *(t for m in rpe
                  for t in (m.weight.to(dt).t().contiguous(), m.bias)),
                nbr_mask, scale)
        else:
            terms = self._flagship_terms \
                if flagship and self.fuse_rpe_matmul else self._variant_terms
            q, k, v = (t.contiguous() for t in terms(q, kvg, edge_feat, N,
                                                      K))
            if self.training and self.attn_drop is not None:
                # JAX's own route under attention dropout: its kernels
                # take no dropout, so the weights are materialized
                out = _materialized_attention(q, k, v, nbr_mask, scale,
                                              self.attn_drop)
            elif self.plain_attention:
                out = dense_attention_reference(q, k, v, nbr_mask, scale)
            elif self.training:
                out = dense_attention_trainable(q, k, v, nbr_mask, scale)
            else:
                out = dense_attention(q, k, v, nbr_mask, scale)
        out = linear(self.out_proj, out.reshape(N, C), dt)
        out = out.to(torch.float32)
        return out if self.drop is None else self.drop(out)


def set_pallas_attention(module, flag, fused_rpe=None,
                         fuse_rpe_matmul=None):
    """JAX's A/B switches of the attention (a process-wide global there),
    set on every `SelfAttentionBlock` of `module`: `flag=False` runs the
    plain attention (`plain_attention`, to compare the kernels with);
    `fused_rpe` and `fuse_rpe_matmul` as in the block. None leaves a
    switch as it is. Returns `module`."""
    for m in module.modules():
        if isinstance(m, SelfAttentionBlock):
            m.plain_attention = not flag
            if fused_rpe is not None:
                m.fused_rpe = bool(fused_rpe)
            if fuse_rpe_matmul is not None:
                m.fuse_rpe_matmul = bool(fuse_rpe_matmul)
    return module
