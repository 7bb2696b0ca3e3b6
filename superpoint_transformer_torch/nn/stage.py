"""Stage / DownNFuseStage / UpNFuseStage / PointStage over padded level
tensors; counterpart of `superpoint_transformer_tpu/nn/stage.py`.

A Stage = position injection (unit-sphere-normalized pos and the parent
diameter, concatenated) -> in_mlp -> N x TransformerBlock -> out_mlp.
Down stages pool children into parents first; up stages broadcast
parents onto children. At the innermost level positions are normalized
per graph, through the `batch` vector.
"""
import torch
from torch import nn

from .mlp import MLP
from .norm import unit_sphere_norm
from .pool import pool
from .transformer import TransformerBlock

__all__ = ['Stage', 'DownNFuseStage', 'UpNFuseStage', 'PointStage',
           'fuse']


def _cat(*xs):
    xs = [x for x in xs if x is not None]
    if not xs:
        return None
    if len(xs) == 1:
        return xs[0]
    return torch.cat(xs, 1)


def fuse(mode, x1, x2):
    """Fuse two feature sets; either may be None. Every config fuses by
    concatenation ('cat'), the only mode ported."""
    if mode not in ('cat', 'concatenate', '|'):
        raise NotImplementedError(f'fusion {mode!r}: only cat is ported')
    return _cat(x1, x2)


class Stage(nn.Module):

    def __init__(self, dim, num_blocks=1, num_heads=1, in_mlp=None,
                 out_mlp=None, use_pos=True,
                 use_diameter=False, use_diameter_parent=False, qk_dim=8,
                 qkv_bias=True, qk_scale=None, in_rpe_dim=18, ffn_ratio=4,
                 no_sa=False, no_ffn=False,
                 k_rpe=False, q_rpe=False, v_rpe=False, qk_share_rpe=False,
                 q_on_minus_rpe=False, heads_share_rpe=False,
                 num_graphs=64, compute_dtype=None, plain_attention=False,
                 device=None):
        super().__init__()
        self.dim = dim
        self.num_blocks = num_blocks
        self.use_pos = use_pos
        self.use_diameter = use_diameter
        self.use_diameter_parent = use_diameter_parent
        self.num_graphs = num_graphs
        mlp = dict(num_graphs=num_graphs, compute_dtype=compute_dtype,
                   device=device)
        if in_mlp is not None:
            self.in_mlp = MLP(in_mlp, **mlp)
        for b in range(num_blocks):
            self.add_module(f'block_{b}', TransformerBlock(
                dim, num_heads=num_heads, qkv_bias=qkv_bias, qk_dim=qk_dim,
                qk_scale=qk_scale, in_rpe_dim=in_rpe_dim,
                ffn_ratio=ffn_ratio, no_sa=no_sa, no_ffn=no_ffn,
                k_rpe=k_rpe, q_rpe=q_rpe,
                v_rpe=v_rpe, qk_share_rpe=qk_share_rpe,
                q_on_minus_rpe=q_on_minus_rpe,
                heads_share_rpe=heads_share_rpe, num_graphs=num_graphs,
                compute_dtype=compute_dtype,
                plain_attention=plain_attention, device=device))
        if out_mlp is not None:
            self.out_mlp = MLP(out_mlp, **mlp)

    @property
    def out_dim(self):
        if hasattr(self, 'out_mlp'):
            return self.out_mlp.out_dim
        return self.dim

    def forward(self, x, norm_index, pos=None, diameter=None,
                node_size=None, super_index=None, num_super=None,
                nbr_idx=None, nbr_mask=None, edge_feat=None, mask=None):
        """Returns (x [N, out_dim], diameter_parent [num_super, 1])."""
        N = (x if x is not None else pos).shape[0]
        dev = (x if x is not None else pos).device
        diameter_parent = None
        if pos is not None:
            if super_index is None:
                # innermost level: normalize per graph
                si, ns = norm_index.clamp(min=0), self.num_graphs
            else:
                si, ns = super_index, num_super
            normalized_pos, diameter_parent = unit_sphere_norm(
                pos, si, ns, node_size=node_size, mask=mask)
            if self.use_pos:
                x = _cat(normalized_pos, x)

        if self.use_diameter:
            diam = diameter if diameter is not None else \
                torch.zeros((N, 1), dtype=torch.float32, device=dev)
            x = _cat(diam, x)

        if self.use_diameter_parent:
            if diameter_parent is None:
                diam = torch.zeros((N, 1), dtype=torch.float32, device=dev)
            elif super_index is None:
                diam = diameter_parent[norm_index.clamp(min=0)]
            else:
                diam = diameter_parent[
                    super_index.clamp(0, num_super - 1)]
            x = _cat(diam, x)

        if hasattr(self, 'in_mlp'):
            x = self.in_mlp(x, batch=norm_index, mask=mask)
        for b in range(self.num_blocks):
            x = getattr(self, f'block_{b}')(
                x, norm_index, nbr_idx=nbr_idx, nbr_mask=nbr_mask,
                edge_feat=edge_feat, mask=mask)
        if hasattr(self, 'out_mlp'):
            x = self.out_mlp(x, batch=norm_index, mask=mask)
        if mask is not None and x is not None:
            x = x * mask[:, None].to(x.dtype)
        return x, diameter_parent


class DownNFuseStage(Stage):
    """Pool children into parents, fuse with the parents' handcrafted
    features, then Stage."""

    def __init__(self, *args, pool='max', fusion='cat', **kwargs):
        super().__init__(*args, **kwargs)
        self.pool = pool
        self.fusion = fusion

    def forward(self, x_parent, x_child, norm_index, pool_index,
                num_parents=None, child_mask=None, **stage_kwargs):
        x_pooled = pool(self.pool, x_child, pool_index, num_parents,
                        mask=child_mask)
        return super().forward(fuse(self.fusion, x_parent, x_pooled),
                               norm_index, **stage_kwargs)


class UpNFuseStage(Stage):
    """Broadcast parent features onto children, fuse with the skip
    features, then Stage."""

    def __init__(self, *args, fusion='cat', **kwargs):
        super().__init__(*args, **kwargs)
        self.fusion = fusion

    def forward(self, x_child, x_parent, norm_index, unpool_index,
                **stage_kwargs):
        idx = unpool_index.clamp(0, x_parent.shape[0] - 1)
        return super().forward(fuse(self.fusion, x_child, x_parent[idx]),
                               norm_index, **stage_kwargs)


class PointStage(Stage):
    """Level-0 encoder: position injection + MLP over raw points, no
    attention. The sparse-CNN branch (EZ-SP) is not ported."""

    def __init__(self, *args, cnn_channels=None, **kwargs):
        if cnn_channels:
            raise NotImplementedError(
                'PointStage: the sparse CNN branch is not ported')
        super().__init__(*args, **kwargs)
