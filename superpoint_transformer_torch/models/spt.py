"""SPT - Superpoint Transformer backbone, counterpart of
`superpoint_transformer_tpu/models/spt.py` for training and inference: a
U-Net over the NAG hierarchy. PointStage encodes level-0 points (after a
sparse CNN over their voxels with `point_cnn`, EZ-SP); DownNFuseStages
pool and self-attend over superpoint levels 1..L; UpNFuseStages decode
back with skip connections; handcrafted node, horizontal-edge and
vertical-edge features are MLP-encoded per level before use
(`share_hf_mlps` names one MLP of each kind `*_mlp_shared`, which JAX
builds for a single level only: over more, flax refuses the name and so
does the port). A nano SPT
(`nano=True`, on a NAG without level 0) has no PointStage: its first
stage is a transformer `Stage` on level 1 with the first down widths,
and its encoder and decoder start one level higher.

Every field of the JAX module is taken, with its meaning there:
the norms of the blocks (`norm`) and of the MLPs (`mlp_norm`), pre- or
post-norm blocks, the pools (`pool`, the attentive one over the
vertical edge features), the fusions, the RPE variants, the dropout
rates (`*_drop`, `*_attn_drop`) and DropPath (`*_drop_path`), drawn from
the model's one `DropoutRNG` (`dropout_rng`, seed 0 until
`dropout_rng.manual_seed`). `stages_share_rpe`, `blocks_share_rpe` and `unpool` are
accepted and do nothing, as in JAX. `norm_mode` other than 'graph'
raises, as JAX does at its first call. Where flax reads a width from the
data, the port takes it as an argument: `point_hf_dim` (the level-0
features the sparse CNN reads), `node_hf_dim` and `v_edge_dim` (the raw
node and vertical-edge features, where the attentive pool reads them
without an MLP).

Consumes a `PaddedNAG` of tensors (`data/padded.py`). Built with
`shard_group` (a process group), it runs on this rank's shard of one
batch (`parallel/shard_nag.py:shard_padded_nag`): every stage reduces its
per-graph statistics over the group and attends over the ranks' gathered
k/v rows (`parallel/mesh.py:make_sharded_forward`).

The forward's sections run in profiler spans (`utils/profiling.py:
annotate`): `spt.hf` (the handcrafted-feature MLPs), `spt.stage.first`,
`spt.stage.down<i>` and `spt.stage.up<i>`; every GraphNorm in its own
`spt.norm` span (`nn/norm.py`).
"""
from torch import nn

from ..nn.dropout import DropoutRNG
from ..nn.mlp import MLP
from ..nn.stage import (DownNFuseStage, UpNFuseStage, PointStage, Stage,
                        _cat)
from ..utils.profiling import annotate

__all__ = ['SPT']


class SPT(nn.Module):

    def __init__(self, point_mlp, nano=False, point_drop=None,
                 point_cnn=None, point_cnn_into_mlp=True,
                 down_dim=(64, 64),
                 down_in_mlp=(), down_out_mlp=None, down_mlp_drop=None,
                 down_num_heads=16, down_num_blocks=3, down_ffn_ratio=1,
                 down_residual_drop=None, down_attn_drop=None,
                 down_drop_path=None, up_dim=(64,), up_in_mlp=(),
                 up_out_mlp=None, up_mlp_drop=None, up_num_heads=16,
                 up_num_blocks=1, up_ffn_ratio=1, up_residual_drop=None,
                 up_attn_drop=None, up_drop_path=None, node_mlp=None,
                 h_edge_mlp=(18, 32, 32), v_edge_mlp=None,
                 share_hf_mlps=False, qk_dim=4, qkv_bias=True,
                 qk_scale=None, in_rpe_dim=32, norm='graph',
                 mlp_norm='graph', pre_norm=True, no_sa=False, no_ffn=True,
                 k_rpe=True, q_rpe=True, v_rpe=True, qk_share_rpe=False,
                 q_on_minus_rpe=False, stages_share_rpe=False,
                 blocks_share_rpe=False, heads_share_rpe=False,
                 use_pos=True, use_node_hf=True, use_diameter=False,
                 use_diameter_parent=True, pool='max', unpool='index',
                 fusion='cat', norm_mode='graph', output_stage_wise=True,
                 num_graphs=8, compute_dtype=None, plain_attention=False,
                 shard_group=None, point_hf_dim=None, node_hf_dim=None,
                 v_edge_dim=None, device=None):
        super().__init__()
        if norm_mode != 'graph':
            raise NotImplementedError(
                f"norm_mode={norm_mode!r}: only 'graph' is supported in "
                'the padded layout')
        self.down_dim, self.up_dim = tuple(down_dim), tuple(up_dim)
        self.nano = bool(nano)
        self.use_node_hf = use_node_hf
        self.output_stage_wise = output_stage_wise
        self.share_hf_mlps = share_hf_mlps
        self.num_graphs = num_graphs
        self.compute_dtype = compute_dtype
        self.shard_group = shard_group
        self.dropout_rng = DropoutRNG()
        num_down = len(down_dim)
        mlp = dict(norm=mlp_norm, num_graphs=num_graphs,
                   compute_dtype=compute_dtype, shard_group=shard_group,
                   device=device)
        # the hf MLPs of the levels 1..L; vertical edges are a level's
        # children's, so a nano SPT has none for its level 1
        for kind, dims, first in (('node', node_mlp, 0),
                                  ('h_edge', h_edge_mlp, 0),
                                  ('v_edge', v_edge_mlp, int(self.nano))):
            if dims is None:
                continue
            if share_hf_mlps and num_down + int(self.nano) - first > 1:
                # flax refuses the one shared name at its second level
                raise ValueError(
                    f'SPT: share_hf_mlps with a {kind} MLP over more than '
                    'one level does not build in the JAX SPT either '
                    f'(NameInUseError on {kind}_mlp_shared)')
            if share_hf_mlps:
                self.add_module(f'{kind}_mlp_shared', MLP(dims, **mlp))
            else:
                for i in range(first, num_down):
                    self.add_module(f'{kind}_mlp_{i}', MLP(dims, **mlp))

        shared = dict(
            qk_dim=qk_dim, qkv_bias=qkv_bias, qk_scale=qk_scale,
            in_rpe_dim=in_rpe_dim, norm=norm, mlp_norm=mlp_norm,
            pre_norm=pre_norm, no_sa=no_sa, no_ffn=no_ffn, k_rpe=k_rpe,
            q_rpe=q_rpe, v_rpe=v_rpe, qk_share_rpe=qk_share_rpe,
            q_on_minus_rpe=q_on_minus_rpe, heads_share_rpe=heads_share_rpe,
            use_pos=use_pos, use_diameter=use_diameter,
            use_diameter_parent=use_diameter_parent, num_graphs=num_graphs,
            compute_dtype=compute_dtype, plain_attention=plain_attention,
            shard_group=shard_group, rng=self.dropout_rng, device=device)
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
            injection = 3 * use_pos + use_diameter + use_diameter_parent
            if point_cnn and point_hf_dim is None:
                if point_cnn_into_mlp:
                    raise ValueError('SPT: point_cnn_into_mlp needs '
                                     'point_hf_dim, the width of the level-0 '
                                     'features the sparse CNN reads')
                point_hf_dim = point_mlp[0] - injection
            self.first_stage = PointStage(
                point_mlp[-1], num_blocks=0, in_mlp=tuple(point_mlp),
                mlp_drop=point_drop,
                cnn_channels=tuple(point_cnn) if point_cnn else None,
                cnn_into_mlp=point_cnn_into_mlp, cnn_in_dim=point_hf_dim,
                **shared)
        hf_dim = node_mlp[-1] if node_mlp is not None else node_hf_dim
        v_dim = v_edge_mlp[-1] if v_edge_mlp is not None else v_edge_dim
        child_dim = self.first_stage.out_dim
        for i in range(self.num_down_stages):
            j = i + self.nano
            stage = DownNFuseStage(
                down_dim[j], pool=pool, fusion=fusion,
                pool_in_dim=child_dim,
                pool_parent_dim=hf_dim if use_node_hf else None,
                pool_rpe_dim=v_dim or 0, **down[j])
            self.add_module(f'down_stage_{i}', stage)
            child_dim = stage.out_dim
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
    def num_up_stages(self):
        return len(self.up_dim)

    @property
    def out_dim(self):
        """Output width of each returned level, low to high (of the one
        output without `output_stage_wise`)."""
        ups = [getattr(self, f'up_stage_{i}').out_dim
               for i in range(self.num_up_stages)]
        last_down = getattr(
            self, f'down_stage_{self.num_down_stages - 1}').out_dim
        if self.output_stage_wise:
            return ups[::-1] + [last_down]
        return ups[-1] if ups else last_down

    def _hf_mlp(self, kind, i_stage):
        name = f'{kind}_mlp_shared' if self.share_hf_mlps \
            else f'{kind}_mlp_{i_stage}'
        return getattr(self, name, None)

    def forward(self, nag):
        if int(self.nano) != nag.start_i_level:
            raise ValueError(
                f'nano={self.nano} must match the NAG\'s start level '
                f'{nag.start_i_level}')
        start, nano = nag.start_i_level, int(self.nano)
        num_down = self.num_down_stages

        # ---- per-level handcrafted-feature MLPs ------------------------
        with annotate('spt.hf'):
            xs, efs, vefs = {}, {}, {}
            for i_stage in range(num_down + nano):
                i_level = i_stage + 1
                lvl = nag[i_level]
                ni = lvl.batch
                x_hf = lvl.x if self.use_node_hf else None
                node_mlp = self._hf_mlp('node', i_stage)
                if x_hf is not None and node_mlp is not None:
                    x_hf = node_mlp(x_hf, batch=ni, mask=lvl.node_mask)
                xs[i_level] = x_hf

                ef = lvl.edge_feat
                h_edge_mlp = self._hf_mlp('h_edge', i_stage)
                if ef is not None and h_edge_mlp is not None:
                    N, K, De = ef.shape
                    em = lvl.nbr_mask.reshape(N * K)
                    flat = h_edge_mlp(ef.reshape(N * K, De),
                                      batch=ni.repeat_interleave(K), mask=em)
                    ef = flat.reshape(N, K, -1) * em.reshape(N, K, 1)
                efs[i_level] = ef

                child = nag[i_level - 1] if i_level - 1 >= start else None
                vef = child.v_edge_attr if child is not None else None
                v_edge_mlp = self._hf_mlp('v_edge', i_stage)
                if vef is not None and v_edge_mlp is not None:
                    vef = v_edge_mlp(vef, batch=child.batch,
                                     mask=child.node_mask)
                vefs[i_level] = vef

        # ---- first stage -------------------------------------------------
        with annotate('spt.stage.first'):
            lvl0 = nag[start]
            if nano:
                # level 1 attends with the first down widths (no pooling)
                x, diameter = self.first_stage(
                    xs[1], lvl0.batch, pos=lvl0.pos,
                    node_size=lvl0.node_size, super_index=lvl0.super_index,
                    num_super=nag[start + 1].capacity, nbr_idx=lvl0.nbr_idx,
                    nbr_mask=lvl0.nbr_mask, edge_feat=efs.get(1),
                    mask=lvl0.node_mask, nbr_in_idx=lvl0.nbr_in_idx,
                    nbr_in_mask=lvl0.nbr_in_mask)
            else:
                x, diameter = self.first_stage(
                    lvl0.x if self.use_node_hf else None, lvl0.batch,
                    cnn_nbr_idx=lvl0.cnn_nbr_idx, pos=lvl0.pos,
                    node_size=lvl0.node_size, super_index=lvl0.super_index,
                    num_super=nag[start + 1].capacity, mask=lvl0.node_mask)
            diameters = {start + 1: diameter}

        # ---- encoder -----------------------------------------------------
        down_outputs = [x] if nano else []
        for i_stage in range(num_down):
            i_level = i_stage + 1 + nano
            lvl, child = nag[i_level], nag[i_level - 1]
            is_last = i_level == nag.end_i_level
            with annotate(f'spt.stage.down{i_stage}'):
                x, diameter = getattr(self, f'down_stage_{i_stage}')(
                    xs[i_level], x, lvl.batch, child.super_index,
                    num_parents=lvl.capacity, child_mask=child.node_mask,
                    v_edge_attr=vefs.get(i_level),
                    pos=lvl.pos, diameter=diameters.get(i_level),
                    node_size=lvl.node_size,
                    super_index=None if is_last else lvl.super_index,
                    num_super=None if is_last
                    else nag[i_level + 1].capacity,
                    nbr_idx=lvl.nbr_idx, nbr_mask=lvl.nbr_mask,
                    edge_feat=efs.get(i_level), mask=lvl.node_mask,
                    nbr_in_idx=lvl.nbr_in_idx, nbr_in_mask=lvl.nbr_in_mask)
            down_outputs.append(x)
            if not is_last:
                diameters[i_level + 1] = diameter

        # ---- decoder -----------------------------------------------------
        up_outputs = []
        for i_stage in range(self.num_up_stages):
            i_level = num_down - i_stage - 1 + nano
            lvl = nag[i_level]
            x_skip = down_outputs[-(2 + i_stage)]
            with annotate(f'spt.stage.up{i_stage}'):
                x, _ = getattr(self, f'up_stage_{i_stage}')(
                    _cat(x_skip, xs[i_level]), x, lvl.batch,
                    lvl.super_index, pos=lvl.pos, node_size=lvl.node_size,
                    super_index=lvl.super_index,
                    num_super=nag[i_level + 1].capacity,
                    nbr_idx=lvl.nbr_idx, nbr_mask=lvl.nbr_mask,
                    edge_feat=efs.get(i_level), mask=lvl.node_mask,
                    nbr_in_idx=lvl.nbr_in_idx, nbr_in_mask=lvl.nbr_in_mask)
            up_outputs.append(x)

        if not self.output_stage_wise:
            return x
        # features for levels 1..L (low to high)
        return [x] + up_outputs[::-1][1:] + [down_outputs[-1]]
