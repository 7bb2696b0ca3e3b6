"""Stage / DownNFuseStage / UpNFuseStage / PointStage over padded level
tensors; counterpart of `superpoint_transformer_tpu/nn/stage.py`.

A Stage = position injection (unit-sphere-normalized pos and the parent
diameter, concatenated) -> in_mlp -> N x TransformerBlock -> out_mlp.
Down stages pool children into parents first (`nn/pool.py`: a segment
pool, or the attentive pool `down_pool_block`); up stages broadcast
parents onto children. Both fuse the two feature sets by `fusion`. At the
innermost level positions are normalized per graph, through the `batch`
vector. The PointStage of EZ-SP runs a sparse CNN (`nn/sparse.py`, the
module `cnn`) over level 0's voxels first.

`shard_group` (graph-partition sharding, `parallel/shard_nag.py`) reaches
every norm and attention block. Of the position norms only the innermost
level's, per graph, crosses the ranks: a parent and its children lie on
one rank.
"""
import torch
from torch import nn

from ..ops.segment import gather_rows
from .mlp import MLP
from .norm import unit_sphere_norm
from .pool import POOL_MODES, AttentivePool, pool
from .sparse import SparseCNN
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
    """Fuse two feature sets; where one is None the other is returned.
    'cat' concatenates them (every config's), 'residual' adds them,
    'first' / 'second' keep one."""
    if x1 is None:
        return x2
    if x2 is None:
        return x1
    if mode in ('cat', 'concatenate', '|'):
        return torch.cat([x1, x2], 1)
    if mode in ('residual', 'additive', '+'):
        return x1 + x2
    if mode in ('first', '1'):
        return x1
    if mode in ('second', '2'):
        return x2
    raise ValueError(f'unknown fusion {mode!r}')


class Stage(nn.Module):

    def __init__(self, dim, num_blocks=1, num_heads=1, in_mlp=None,
                 out_mlp=None, use_pos=True,
                 use_diameter=False, use_diameter_parent=False, qk_dim=8,
                 qkv_bias=True, qk_scale=None, in_rpe_dim=18, ffn_ratio=4,
                 mlp_drop=None, mlp_norm='graph', residual_drop=None,
                 attn_drop=None, drop_path=None, norm='graph',
                 pre_norm=True, no_sa=False, no_ffn=False,
                 k_rpe=False, q_rpe=False, v_rpe=False, qk_share_rpe=False,
                 q_on_minus_rpe=False, heads_share_rpe=False,
                 num_graphs=64, compute_dtype=None, plain_attention=False,
                 shard_group=None, rng=None, device=None):
        super().__init__()
        self.dim = dim
        self.num_blocks = num_blocks
        self.use_pos = use_pos
        self.use_diameter = use_diameter
        self.use_diameter_parent = use_diameter_parent
        self.num_graphs = num_graphs
        self.shard_group = shard_group
        mlp = dict(norm=mlp_norm, drop=mlp_drop, num_graphs=num_graphs,
                   compute_dtype=compute_dtype, shard_group=shard_group,
                   rng=rng, device=device)
        if in_mlp is not None:
            self.in_mlp = MLP(in_mlp, **mlp)
        for b in range(num_blocks):
            self.add_module(f'block_{b}', TransformerBlock(
                dim, num_heads=num_heads, qkv_bias=qkv_bias, qk_dim=qk_dim,
                qk_scale=qk_scale, in_rpe_dim=in_rpe_dim,
                ffn_ratio=ffn_ratio, residual_drop=residual_drop,
                attn_drop=attn_drop, drop_path=drop_path, norm=norm,
                pre_norm=pre_norm, no_sa=no_sa, no_ffn=no_ffn,
                k_rpe=k_rpe, q_rpe=q_rpe,
                v_rpe=v_rpe, qk_share_rpe=qk_share_rpe,
                q_on_minus_rpe=q_on_minus_rpe,
                heads_share_rpe=heads_share_rpe, num_graphs=num_graphs,
                compute_dtype=compute_dtype,
                plain_attention=plain_attention, shard_group=shard_group,
                rng=rng, device=device))
        if out_mlp is not None:
            self.out_mlp = MLP(out_mlp, **mlp)

    @property
    def out_dim(self):
        if hasattr(self, 'out_mlp'):
            return self.out_mlp.out_dim
        return self.dim

    def forward(self, x, norm_index, pos=None, diameter=None,
                node_size=None, super_index=None, num_super=None,
                nbr_idx=None, nbr_mask=None, edge_feat=None, mask=None,
                nbr_in_idx=None, nbr_in_mask=None):
        """Returns (x [N, out_dim], diameter_parent [num_super, 1])."""
        N = (x if x is not None else pos).shape[0]
        dev = (x if x is not None else pos).device
        diameter_parent = None
        if pos is not None:
            if super_index is None:
                # innermost level: normalize per graph, over the ranks
                si, ns = norm_index.clamp(min=0), self.num_graphs
                group = self.shard_group
            else:
                si, ns, group = super_index, num_super, None
            # a level is sorted by parent; graph ids with the padded
            # rows' -1 clamped to 0 are not
            normalized_pos, diameter_parent = unit_sphere_norm(
                pos, si, ns, node_size=node_size, mask=mask,
                indices_are_sorted=super_index is not None,
                shard_group=group)
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
                edge_feat=edge_feat, mask=mask, nbr_in_idx=nbr_in_idx,
                nbr_in_mask=nbr_in_mask)
        if hasattr(self, 'out_mlp'):
            x = self.out_mlp(x, batch=norm_index, mask=mask)
        if mask is not None and x is not None:
            x = x * mask[:, None].to(x.dtype)
        return x, diameter_parent


class DownNFuseStage(Stage):
    """Pool children into parents, fuse with the parents' handcrafted
    features, then Stage. `pool` is a segment pool ('max', 'min', 'mean',
    'sum', 'std') or 'attentive' (`AttentivePool` on the stage's heads,
    qk_dim, scale and k/q RPE flags, over the vertical edge features),
    which needs the widths of the child features `pool_in_dim`, of the
    parent features `pool_parent_dim` and of the vertical edge features
    `pool_rpe_dim` (0: none)."""

    def __init__(self, *args, pool='max', fusion='cat', pool_in_dim=None,
                 pool_parent_dim=None, pool_rpe_dim=0, **kwargs):
        super().__init__(*args, **kwargs)
        self.pool = pool
        self.fusion = fusion
        if pool == 'attentive':
            self.down_pool_block = AttentivePool(
                self.dim, pool_in_dim, parent_dim=pool_parent_dim,
                num_heads=kwargs.get('num_heads', 1),
                qk_dim=kwargs.get('qk_dim', 8),
                qk_scale=kwargs.get('qk_scale'), in_rpe_dim=pool_rpe_dim,
                k_rpe=kwargs.get('k_rpe', False),
                q_rpe=kwargs.get('q_rpe', False),
                heads_share_rpe=kwargs.get('heads_share_rpe', False),
                device=kwargs.get('device'))
        elif pool not in POOL_MODES:
            raise ValueError(f'unknown pool {pool!r}')

    def forward(self, x_parent, x_child, norm_index, pool_index,
                num_parents=None, child_mask=None, v_edge_attr=None,
                **stage_kwargs):
        if self.pool == 'attentive':
            x_pooled = self.down_pool_block(
                x_child, x_parent, pool_index, num_parents,
                edge_attr=v_edge_attr, mask=child_mask)
        else:
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
        return super().forward(fuse(self.fusion, x_child,
                                    gather_rows(x_parent, idx)),
                               norm_index, **stage_kwargs)


class PointStage(Stage):
    """Level-0 encoder: position injection + MLP over raw points, no
    attention. With `cnn_channels` (EZ-SP), a sparse CNN `cnn` runs first
    over the voxels' kernel-neighbor table `cnn_nbr_idx` (its input the
    `cnn_in_dim` point features, its norm `cnn_norm`); its output
    replaces the point features ahead of the MLP (`cnn_into_mlp`), or is
    concatenated to the MLP output."""

    def __init__(self, *args, cnn_channels=None, cnn_into_mlp=True,
                 cnn_in_dim=None, cnn_norm='graph', **kwargs):
        super().__init__(*args, **kwargs)
        self.cnn_into_mlp = cnn_into_mlp
        if cnn_channels:
            if not cnn_in_dim:
                raise ValueError('PointStage: the sparse CNN needs the width '
                                 'of the point features (cnn_in_dim)')
            self.cnn = SparseCNN(cnn_in_dim, cnn_channels, norm=cnn_norm,
                                 num_graphs=self.num_graphs,
                                 device=kwargs.get('device'))

    @property
    def out_dim(self):
        dim = super().out_dim
        if hasattr(self, 'cnn') and not self.cnn_into_mlp:
            dim += self.cnn.out_dim
        return dim

    def forward(self, x, norm_index, cnn_nbr_idx=None, mask=None,
                **stage_kwargs):
        x_cnn = None
        if hasattr(self, 'cnn'):
            if cnn_nbr_idx is None:
                raise ValueError(
                    'PointStage: the sparse CNN needs the batch\'s '
                    '`cnn_nbr_idx` (level-0 `coords` at padding)')
            x_cnn = self.cnn(x, cnn_nbr_idx, batch=norm_index, mask=mask)
            if self.cnn_into_mlp:
                x, x_cnn = x_cnn, None
        out, diameter = super().forward(x, norm_index, mask=mask,
                                        **stage_kwargs)
        if x_cnn is not None:
            out = torch.cat([out, x_cnn], 1)
        return out, diameter
