"""TransformerBlock: pre-norm residual self-attention and FFN with
GraphNorm.

Counterpart of `superpoint_transformer_tpu/nn/transformer.py` in the
pre-norm form every config uses, for training and inference. v3
semantics: the FFN residual shortcut re-bases on the SA output. No config
sets a DropPath or dropout rate, so those accept only None or 0.
`shard_group` reaches the norms and the attention (graph-partition
sharding, `parallel/shard_nag.py`).
"""
from torch import nn

from .attention import SelfAttentionBlock
from .mlp import FFN
from .norm import GraphNorm

__all__ = ['TransformerBlock']


class TransformerBlock(nn.Module):

    def __init__(self, dim, num_heads=1, qkv_bias=True, qk_dim=8,
                 qk_scale=None, in_rpe_dim=18, ffn_ratio=4,
                 residual_drop=None, attn_drop=None, drop_path=None,
                 no_sa=False, no_ffn=False, k_rpe=False,
                 q_rpe=False, v_rpe=False, qk_share_rpe=False,
                 q_on_minus_rpe=False, heads_share_rpe=False,
                 num_graphs=64, compute_dtype=None, plain_attention=False,
                 shard_group=None, device=None):
        super().__init__()
        for name, rate in (('residual_drop', residual_drop),
                           ('drop_path', drop_path)):
            if rate:
                raise NotImplementedError(
                    f'TransformerBlock: {name}={rate} is not ported')
        if not no_sa:
            self.sa_norm = GraphNorm(dim, num_graphs=num_graphs,
                                     shard_group=shard_group, device=device)
            self.sa = SelfAttentionBlock(
                dim, num_heads=num_heads, qkv_bias=qkv_bias,
                qk_dim=qk_dim, qk_scale=qk_scale, in_rpe_dim=in_rpe_dim,
                k_rpe=k_rpe, q_rpe=q_rpe, v_rpe=v_rpe,
                qk_share_rpe=qk_share_rpe, q_on_minus_rpe=q_on_minus_rpe,
                heads_share_rpe=heads_share_rpe, attn_drop=attn_drop,
                compute_dtype=compute_dtype,
                plain_attention=plain_attention, shard_group=shard_group,
                device=device)
        if not no_ffn:
            self.ffn_norm = GraphNorm(dim, num_graphs=num_graphs,
                                      shard_group=shard_group, device=device)
            self.ffn = FFN(dim, hidden_dim=int(dim * ffn_ratio),
                           device=device)

    def forward(self, x, norm_index, nbr_idx=None, nbr_mask=None,
                edge_feat=None, mask=None, nbr_in_idx=None,
                nbr_in_mask=None):
        if hasattr(self, 'sa') and nbr_idx is not None:
            h = self.sa_norm(x, batch=norm_index, mask=mask)
            x = x + self.sa(h, nbr_idx, nbr_mask, edge_feat,
                            nbr_in_idx=nbr_in_idx, nbr_in_mask=nbr_in_mask)
        if hasattr(self, 'ffn'):
            x = x + self.ffn(self.ffn_norm(x, batch=norm_index, mask=mask))
        return x
