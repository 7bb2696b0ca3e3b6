"""SPT - Superpoint Transformer backbone, counterpart of
`superpoint_transformer_tpu/models/spt.py` for training and inference
(the dropout and DropPath rates accept only None or 0: no config sets
them, and the stages raise on any other value): a U-Net over
the NAG hierarchy. PointStage encodes level-0 points; DownNFuseStages
pool and self-attend over superpoint levels 1..L; UpNFuseStages decode
back with skip connections; handcrafted node and horizontal-edge
features are MLP-encoded per level before use. A nano SPT (`nano=True`,
on a NAG without level 0) has no PointStage: its first stage is a
transformer `Stage` on level 1 with the first down widths, and its
encoder and decoder start one level higher.

Consumes a `PaddedNAG` of tensors (`data/padded.py`). Built with
`shard_group` (a process group), it runs on this rank's shard of one
batch (`parallel/shard_nag.py:shard_padded_nag`): every stage reduces its
per-graph statistics over the group and attends over the ranks' gathered
k/v rows (`parallel/mesh.py:make_sharded_forward`).
"""
from torch import nn

from ..nn.mlp import MLP
from ..nn.stage import (DownNFuseStage, UpNFuseStage, PointStage, Stage,
                        _cat)

__all__ = ['SPT']


class SPT(nn.Module):

    def __init__(self, point_mlp, nano=False, point_drop=None,
                 down_dim=(64, 64),
                 down_in_mlp=(), down_out_mlp=None, down_mlp_drop=None,
                 down_num_heads=16, down_num_blocks=3, down_ffn_ratio=1,
                 down_residual_drop=None, down_attn_drop=None,
                 down_drop_path=None, up_dim=(64,), up_in_mlp=(),
                 up_out_mlp=None, up_mlp_drop=None, up_num_heads=16,
                 up_num_blocks=1, up_ffn_ratio=1, up_residual_drop=None,
                 up_attn_drop=None, up_drop_path=None, node_mlp=None, h_edge_mlp=(18, 32, 32),
                 v_edge_mlp=None, qk_dim=4, qkv_bias=True, qk_scale=None,
                 in_rpe_dim=32, pre_norm=True, no_sa=False, no_ffn=True,
                 k_rpe=True, q_rpe=True, v_rpe=True, qk_share_rpe=False,
                 q_on_minus_rpe=False, heads_share_rpe=False, use_pos=True,
                 use_node_hf=True, use_diameter=False,
                 use_diameter_parent=True, pool='max', fusion='cat',
                 norm_mode='graph', num_graphs=8, compute_dtype=None,
                 plain_attention=False, shard_group=None, device=None):
        super().__init__()
        if norm_mode != 'graph':
            raise NotImplementedError(
                f"norm_mode={norm_mode!r}: only 'graph' is supported in "
                'the padded layout')
        if not pre_norm:
            raise NotImplementedError('post-norm blocks are not ported')
        self.down_dim, self.up_dim = tuple(down_dim), tuple(up_dim)
        self.nano = bool(nano)
        self.use_node_hf = use_node_hf
        self.num_graphs = num_graphs
        self.compute_dtype = compute_dtype
        self.shard_group = shard_group
        num_down = len(down_dim)
        mlp = dict(num_graphs=num_graphs, compute_dtype=compute_dtype,
                   shard_group=shard_group, device=device)
        if v_edge_mlp is not None or pool != 'max':
            # vertical edge features feed only the attentive pool
            raise NotImplementedError(
                'SPT: only max pooling (no v_edge_mlp) is ported')
        for kind, dims in (('node', node_mlp), ('h_edge', h_edge_mlp)):
            if dims is not None:
                for i in range(num_down):
                    self.add_module(f'{kind}_mlp_{i}', MLP(dims, **mlp))

        shared = dict(
            qk_dim=qk_dim, qkv_bias=qkv_bias, qk_scale=qk_scale,
            in_rpe_dim=in_rpe_dim, no_sa=no_sa, no_ffn=no_ffn, k_rpe=k_rpe,
            q_rpe=q_rpe, v_rpe=v_rpe, qk_share_rpe=qk_share_rpe,
            q_on_minus_rpe=q_on_minus_rpe, heads_share_rpe=heads_share_rpe,
            use_pos=use_pos, use_diameter=use_diameter,
            use_diameter_parent=use_diameter_parent, num_graphs=num_graphs,
            compute_dtype=compute_dtype, plain_attention=plain_attention,
            shard_group=shard_group, device=device)
        down = [dict(
            num_blocks=down_num_blocks, num_heads=down_num_heads,
            in_mlp=tuple(down_in_mlp[j]),
            out_mlp=(tuple(down_out_mlp[j]) if down_out_mlp else None),
            ffn_ratio=down_ffn_ratio, mlp_drop=down_mlp_drop,
            residual_drop=down_residual_drop, attn_drop=down_attn_drop,
            drop_path=down_drop_path, **shared) for j in range(num_down)]
        if self.nano:
            self.first_stage = Stage(down_dim[0], **down[0])
        else:
            self.first_stage = PointStage(
                point_mlp[-1], num_blocks=0, in_mlp=tuple(point_mlp),
                mlp_drop=point_drop, **shared)
        for i in range(self.num_down_stages):
            j = i + self.nano
            self.add_module(f'down_stage_{i}', DownNFuseStage(
                down_dim[j], pool=pool, fusion=fusion, **down[j]))
        for i in range(len(up_dim)):
            self.add_module(f'up_stage_{i}', UpNFuseStage(
                up_dim[i], num_blocks=up_num_blocks,
                num_heads=up_num_heads, in_mlp=tuple(up_in_mlp[i]),
                out_mlp=(tuple(up_out_mlp[i]) if up_out_mlp else None),
                ffn_ratio=up_ffn_ratio, mlp_drop=up_mlp_drop,
                residual_drop=up_residual_drop, attn_drop=up_attn_drop,
                drop_path=up_drop_path, fusion=fusion, **shared))

    @property
    def num_down_stages(self):
        return len(self.down_dim) - self.nano

    @property
    def out_dim(self):
        """Output width of each returned level, low to high."""
        ups = [getattr(self, f'up_stage_{i}').out_dim
               for i in range(len(self.up_dim))]
        last_down = getattr(
            self, f'down_stage_{self.num_down_stages - 1}').out_dim
        return ups[::-1] + [last_down]

    def forward(self, nag):
        if int(self.nano) != nag.start_i_level:
            raise ValueError(
                f'nano={self.nano} must match the NAG\'s start level '
                f'{nag.start_i_level}')
        start, nano = nag.start_i_level, int(self.nano)
        num_down = self.num_down_stages

        # ---- per-level handcrafted-feature MLPs ------------------------
        xs, efs = {}, {}
        for i_stage in range(num_down + nano):
            i_level = i_stage + 1
            lvl = nag[i_level]
            ni = lvl.batch
            x_hf = lvl.x if self.use_node_hf else None
            node_mlp = getattr(self, f'node_mlp_{i_stage}', None)
            if x_hf is not None and node_mlp is not None:
                x_hf = node_mlp(x_hf, batch=ni, mask=lvl.node_mask)
            xs[i_level] = x_hf

            ef = lvl.edge_feat
            h_edge_mlp = getattr(self, f'h_edge_mlp_{i_stage}', None)
            if ef is not None and h_edge_mlp is not None:
                N, K, De = ef.shape
                em = lvl.nbr_mask.reshape(N * K)
                flat = h_edge_mlp(ef.reshape(N * K, De),
                                  batch=ni.repeat_interleave(K), mask=em)
                ef = flat.reshape(N, K, -1) * em.reshape(N, K, 1)
            efs[i_level] = ef

        # ---- first stage -------------------------------------------------
        lvl0 = nag[start]
        if nano:
            # level 1 attends with the first down widths (no pooling)
            x, diameter = self.first_stage(
                xs[1], lvl0.batch, pos=lvl0.pos, node_size=lvl0.node_size,
                super_index=lvl0.super_index,
                num_super=nag[start + 1].capacity, nbr_idx=lvl0.nbr_idx,
                nbr_mask=lvl0.nbr_mask, edge_feat=efs.get(1),
                mask=lvl0.node_mask, nbr_in_idx=lvl0.nbr_in_idx,
                nbr_in_mask=lvl0.nbr_in_mask)
        else:
            x, diameter = self.first_stage(
                lvl0.x if self.use_node_hf else None, lvl0.batch,
                pos=lvl0.pos, node_size=lvl0.node_size,
                super_index=lvl0.super_index,
                num_super=nag[start + 1].capacity, mask=lvl0.node_mask)
        diameters = {start + 1: diameter}

        # ---- encoder -----------------------------------------------------
        down_outputs = [x] if nano else []
        for i_stage in range(num_down):
            i_level = i_stage + 1 + nano
            lvl, child = nag[i_level], nag[i_level - 1]
            is_last = i_level == nag.end_i_level
            x, diameter = getattr(self, f'down_stage_{i_stage}')(
                xs[i_level], x, lvl.batch, child.super_index,
                num_parents=lvl.capacity, child_mask=child.node_mask,
                pos=lvl.pos, diameter=diameters.get(i_level),
                node_size=lvl.node_size,
                super_index=None if is_last else lvl.super_index,
                num_super=None if is_last else nag[i_level + 1].capacity,
                nbr_idx=lvl.nbr_idx, nbr_mask=lvl.nbr_mask,
                edge_feat=efs.get(i_level), mask=lvl.node_mask,
                nbr_in_idx=lvl.nbr_in_idx, nbr_in_mask=lvl.nbr_in_mask)
            down_outputs.append(x)
            if not is_last:
                diameters[i_level + 1] = diameter

        # ---- decoder -----------------------------------------------------
        up_outputs = []
        for i_stage in range(len(self.up_dim)):
            i_level = num_down - i_stage - 1 + nano
            lvl = nag[i_level]
            x_skip = down_outputs[-(2 + i_stage)]
            x, _ = getattr(self, f'up_stage_{i_stage}')(
                _cat(x_skip, xs[i_level]), x, lvl.batch, lvl.super_index,
                pos=lvl.pos, node_size=lvl.node_size,
                super_index=lvl.super_index,
                num_super=nag[i_level + 1].capacity, nbr_idx=lvl.nbr_idx,
                nbr_mask=lvl.nbr_mask, edge_feat=efs.get(i_level),
                mask=lvl.node_mask, nbr_in_idx=lvl.nbr_in_idx,
                nbr_in_mask=lvl.nbr_in_mask)
            up_outputs.append(x)

        # features for levels 1..L (low to high)
        return [x] + up_outputs[::-1][1:] + [down_outputs[-1]]
