"""TransformerBlock: residual self-attention and FFN, pre-norm or
post-norm, with DropPath.

Counterpart of `superpoint_transformer_tpu/nn/transformer.py`. v3
semantics: the FFN residual shortcut re-bases on the SA output. Pre-norm
(every config's) normalizes each branch's input, post-norm the sum of
the shortcut and the branch. `norm` is 'graph' (GraphNorm), 'layer',
'instance' or 'batch'; the JAX block cannot build 'group' (its GroupNorm
takes no `shard_axis`), nor can this one. `drop_path` drops a node's
whole branch (`nn/dropout.py:DropPath`) and `residual_drop` the output of
the attention and of the FFN, in training; `attn_drop` reaches the
attention. `shard_group` reaches the norms and the attention
(graph-partition sharding, `parallel/shard_nag.py`).
"""
from torch import nn

from .attention import SelfAttentionBlock
from .dropout import DropoutRNG, DropPath
from .mlp import FFN
from .norm import make_norm

__all__ = ['TransformerBlock']


class TransformerBlock(nn.Module):

    def __init__(self, dim, num_heads=1, qkv_bias=True, qk_dim=8,
                 qk_scale=None, in_rpe_dim=18, ffn_ratio=4,
                 residual_drop=None, attn_drop=None, drop_path=None,
                 norm='graph', pre_norm=True, no_sa=False, no_ffn=False,
                 k_rpe=False, q_rpe=False, v_rpe=False, qk_share_rpe=False,
                 q_on_minus_rpe=False, heads_share_rpe=False,
                 num_graphs=64, compute_dtype=None, plain_attention=False,
                 shard_group=None, rng=None, device=None):
        super().__init__()
        if norm == 'group':
            raise ValueError(
                "TransformerBlock: norm='group' is not built by the JAX "
                'block either (its GroupNorm takes no shard_axis)')
        self.pre_norm = pre_norm
        self.drop_path = DropPath(drop_path, rng or DropoutRNG()) \
            if drop_path else None
        norm_kw = dict(num_graphs=num_graphs, shard_group=shard_group,
                       device=device)
        if not no_sa:
            self.sa_norm = make_norm(norm, dim, **norm_kw)
            self.sa = SelfAttentionBlock(
                dim, num_heads=num_heads, qkv_bias=qkv_bias,
                qk_dim=qk_dim, qk_scale=qk_scale, in_rpe_dim=in_rpe_dim,
                k_rpe=k_rpe, q_rpe=q_rpe, v_rpe=v_rpe,
                qk_share_rpe=qk_share_rpe, q_on_minus_rpe=q_on_minus_rpe,
                heads_share_rpe=heads_share_rpe, attn_drop=attn_drop,
                drop=residual_drop, compute_dtype=compute_dtype,
                plain_attention=plain_attention, shard_group=shard_group,
                rng=rng, device=device)
        if not no_ffn:
            self.ffn_norm = make_norm(norm, dim, **norm_kw)
            self.ffn = FFN(dim, hidden_dim=int(dim * ffn_ratio),
                           drop=residual_drop, rng=rng, device=device)

    def _dp(self, h):
        return h if self.drop_path is None else self.drop_path(h)

    def forward(self, x, norm_index, nbr_idx=None, nbr_mask=None,
                edge_feat=None, mask=None, nbr_in_idx=None,
                nbr_in_mask=None):
        sa_kw = dict(nbr_in_idx=nbr_in_idx, nbr_in_mask=nbr_in_mask)
        if hasattr(self, 'sa') and nbr_idx is not None:
            if self.pre_norm:
                h = self.sa_norm(x, batch=norm_index, mask=mask)
                x = x + self._dp(self.sa(h, nbr_idx, nbr_mask, edge_feat,
                                         **sa_kw))
            else:
                h = self.sa(x, nbr_idx, nbr_mask, edge_feat, **sa_kw)
                x = self.sa_norm(x + self._dp(h), batch=norm_index,
                                 mask=mask)
        if hasattr(self, 'ffn'):
            if self.pre_norm:
                h = self.ffn_norm(x, batch=norm_index, mask=mask)
                x = x + self._dp(self.ffn(h))
            else:
                x = self.ffn_norm(x + self._dp(self.ffn(x)),
                                  batch=norm_index, mask=mask)
        return x
