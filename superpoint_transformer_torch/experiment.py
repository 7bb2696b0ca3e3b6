"""Experiment construction: config -> SPT backbone -> semantic or
panoptic task, or EZ-SP's partition task, batch configuration and
datasets.

Counterpart of `build_model`, `build_task` (semantic, panoptic, partition),
`build_batch_config`, `_pre_transform_config` and `build_datasets` in
`superpoint_transformer_tpu/experiment.py`, over a plain nested dict or a
`config.Config`. `FLAGSHIP_CFG` holds the values that they and the
Trainer read from `configs/train.yaml` composed with
`experiment=semantic/s3dis`, `PANOPTIC_CFG` those of
`experiment=panoptic/s3dis`, `EZSP_PARTITION_CFG` / `EZSP_CFG` those
of EZ-SP's two stages, `NANO_CFG` / `PANOPTIC_NANO_CFG` nano's, and
`DALES_CFG`, `KITTI360_CFG` and `PANOPTIC_SCANNET_CFG` SPT-3's on the
other datasets, so no YAML reader is needed; tests pin each to the
YAML. `build_model` and `build_task` build on the card unless the
caller passes `device='cpu'`.
"""
import copy

import numpy as np
import torch

from .models.panoptic import PanopticTask
from .models.partition import PartitionModel, PartitionTask
from .models.semantic import SemanticTask
from .models.spt import SPT
from .transforms.prepare import BatchConfig

__all__ = ['FEAT_SIZE', 'FLAGSHIP_CFG', 'PANOPTIC_CFG', 'EZSP_PARTITION_CFG',
           'EZSP_CFG', 'NANO_CFG', 'PANOPTIC_NANO_CFG', 'DALES_CFG',
           'KITTI360_CFG', 'PANOPTIC_SCANNET_CFG', 'build_model',
           'build_task', 'build_batch_config', 'build_datasets',
           'precision_to_dtype']


def precision_to_dtype(precision):
    """Map a `trainer.precision` value to the model's `compute_dtype`:
    '16' and 'bf16' variants select bfloat16, 32-bit values select full
    float32 (None)."""
    if precision is None:
        return None
    p = str(precision).lower()
    if 'bf16' in p or p in ('16', '16-mixed', '16-true'):
        return 'bfloat16'
    if p in ('32', '32-true', 'fp32', 'float32'):
        return None
    raise ValueError(
        f'unknown trainer.precision {precision!r} '
        '(expected one of: 32, 16, bf16, bf16-mixed, 16-mixed)')


FEAT_SIZE = {
    'pos': 3, 'pos_room': 3, 'rgb': 3, 'hsv': 3, 'lab': 3,
    'density': 1, 'linearity': 1, 'planarity': 1, 'scattering': 1,
    'verticality': 1, 'normal': 3, 'length': 1, 'surface': 1,
    'volume': 1, 'curvature': 1, 'elevation': 1, 'size': 1,
    'intensity': 1, 'mean_off': 3, 'std_off': 3, 'mean_dist': 1,
    'angle_source': 1, 'angle_target': 1, 'centroid_dir': 3,
    'centroid_dist': 1, 'normal_angle': 1, 'log_length': 1,
    'log_surface': 1, 'log_volume': 1, 'log_size': 1,
}
for _k in list(FEAT_SIZE):
    FEAT_SIZE.setdefault('mean_' + _k, FEAT_SIZE[_k])
    FEAT_SIZE.setdefault('std_' + _k, FEAT_SIZE[_k])
    FEAT_SIZE.setdefault('log_' + _k, FEAT_SIZE[_k])

# SPT-2 on S3DIS with bf16 compute: the values that build_model,
# build_task, build_batch_config, _pre_transform_config, build_datasets
# and the train entry point read from configs/train.yaml +
# experiment=semantic/s3dis
FLAGSHIP_CFG = {
    'seed': 0,
    'output_dir': 'outputs',
    'ckpt_path': None,
    'datamodule': {
        'dataset': 's3dis',
        'data_dir': 'data',
        'fold': 5,
        'mini': False,
        'in_memory': True,
        'num_workers': 1,
        'dataloader': {'batch_size': 1, 'num_workers': 0},
        'num_classes': 13,
        'stuff_classes': [],
        'nano': False,
        'instance': False,
        # preprocessing
        'voxel': 0.03,
        'knn': 45,
        'knn_r': 2,
        'knn_step': -1,
        'knn_min_search': 25,
        'knn_backend': 'host',
        'partition_hf': ['rgb', 'linearity', 'planarity', 'scattering',
                         'verticality', 'elevation'],
        'pcp_regularization': [0.01, 0.1, 0.5],
        'pcp_spatial_weight': [0.1, 0.1, 0.1],
        'pcp_cutoff': [10, 10, 10],
        'pcp_k_adjacency': 10,
        'pcp_w_adjacency': 1,
        'graph_k_min': 1,
        'graph_k_max': 30,
        'graph_gap': [0.2, 0.5, 1],
        'ground_threshold': 1.5,
        'ground_scale': 4.0,
        # batches: sampling and augmentation
        'sample_point_min': 32,
        'sample_point_max': 128,
        'sample_graph_r': 7,
        'sample_graph_k': 4,
        'sample_graph_max_nodes': 10000,
        'sample_segment_ratio': 0.1,
        'sample_segment_by_size': True,
        'sample_edge_n_max': -1,
        'max_num_nodes': 50000,
        'max_num_edges': 1000000,
        'pos_jitter': 0.03,
        'tilt_n_rotate_phi': 0.1,
        'tilt_n_rotate_theta': 180,
        'anisotropic_scaling': 0.2,
        'node_feat_jitter': 0.01,
        'h_edge_feat_jitter': 0.01,
        'rgb_autocontrast': 0.5,
        'rgb_drop': 0.3,
        'point_hf': ['linearity', 'planarity', 'scattering',
                     'verticality', 'elevation', 'rgb'],
        'segment_base_hf': [],
        'segment_mean_hf': [],
        'segment_std_hf': [],
        'edge_hf': ['mean_off', 'std_off', 'mean_dist', 'angle_source',
                    'angle_target', 'centroid_dir', 'centroid_dist',
                    'normal_angle', 'log_length', 'log_surface',
                    'log_volume', 'log_size'],
        'v_edge_hf': [],
    },
    'model': {
        '_point_mlp': [32, 64, 128],
        '_node_mlp_out': 32,
        '_h_edge_mlp_out': 32,
        '_v_edge_mlp_out': 32,
        '_down_dim': [64, 64],
        '_up_dim': [64],
        '_mlp_depth': 2,
        'loss_type': 'ce_kl',
        'multi_stage_loss_lambdas': [1, 50],
        'weighted_loss': True,
        'weighted_loss_smooth': 'sqrt',
        'transformer_lr_scale': 0.1,
        # the YAML loader reads `1e-2` (no dot) as a string, and these
        # values are kept as it gives them; build_task converts
        'optimizer': {'lr': 0.1, 'weight_decay': '1e-2'},
        'scheduler': {'eta_min': '1e-6', 'warmup_init_lr': '1e-6',
                      'num_warmup': 20},
        'net': {
            'nano': False, 'use_pos': True, 'use_node_hf': True,
            'use_diameter': False, 'use_diameter_parent': True,
            'pool': 'max', 'fusion': 'cat', 'norm_mode': 'graph',
            'qk_dim': 4, 'qkv_bias': True, 'qk_scale': None,
            'pre_norm': True, 'no_sa': False, 'no_ffn': True,
            'k_rpe': True, 'q_rpe': True, 'v_rpe': True,
            'qk_share_rpe': False, 'q_on_minus_rpe': False,
            'heads_share_rpe': False,
            'down_num_heads': 16, 'down_num_blocks': 3,
            'down_ffn_ratio': 1,
            'up_num_heads': 16, 'up_num_blocks': 1, 'up_ffn_ratio': 1,
        },
    },
    'trainer': {
        'precision': 'bf16',
        'max_epochs': 2000,
        'check_val_every_n_epoch': 10,
        'devices': 1,
        'accumulate_grad_batches': 1,
        'early_stopping_patience': -1,
        'logger': ['csv'],
        'track_val_idx': -1,
    },
}

# SuperCluster on S3DIS (SPT-2 backbone, bf16 compute): the values
# build_model and build_task read from configs/train.yaml +
# experiment=panoptic/s3dis. The backbone's are FLAGSHIP_CFG's.
PANOPTIC_CFG = copy.deepcopy(FLAGSHIP_CFG)
PANOPTIC_CFG['datamodule'].update({
    'instance': True,
    'instance_k_max': 30,
    'instance_radius': 0.1,
    'stuff_classes': [],
})
PANOPTIC_CFG['model'].update({
    'task': 'panoptic',
    # no builder reads this one, here or in JAX: the head keeps
    # PanopticSegmentationModel's default width, this same 32; it stays
    # so that the test pinning PANOPTIC_CFG to the YAML holds it
    'edge_affinity_head_hidden': 32,
    'edge_affinity_loss_lambda': 1,
    'edge_affinity_loss_weights': [1, 1, 1, 1],
    'partition_every_n_epoch': 50,
})


# EZ-SP on S3DIS: the values that build_task, build_datasets and the train
# entry point read from configs/train.yaml + experiment=partition/
# s3dis_ezsp (stage 1: the sparse CNN in f32) and + experiment=
# semantic/s3dis_ezsp (stage 2: SPT-2 on the learned partition, whose
# `datamodule.pretrained_cnn_ckpt_path` is the stage-1 checkpoint). Both
# datamodules are FLAGSHIP_CFG's with the contour-prior keys; stage 1
# preprocesses as the flagship does (one cache for both).
_CONTOUR_PRIOR = {
    'contour_prior_reg': '2e-2',
    'contour_prior_min_size': [5, 30, 90],
    'contour_prior_edge_weight_mode': 'exp_neg_latent_distance',
    'contour_prior_k_isolated': 5,
    'num_hf_partition': 6,
}
EZSP_PARTITION_CFG = copy.deepcopy(FLAGSHIP_CFG)
EZSP_PARTITION_CFG['datamodule'].update(_CONTOUR_PRIOR)
EZSP_PARTITION_CFG['model'].update({
    'task': 'partition',
    'cnn_width': 32,
    'cnn_depth': 2,
    'cnn_out': 32,
    'partition_criterion': {'gamma': 1, 'affinity_temperature': 1,
                            'adaptive_sampling_ratio': 0.9},
    'optimizer': {'lr': '1e-4', 'weight_decay': '1e-4'},
    'scheduler': None,
})
EZSP_PARTITION_CFG['trainer']['max_epochs'] = 100
EZSP_CFG = copy.deepcopy(FLAGSHIP_CFG)
EZSP_CFG['datamodule'].update(_CONTOUR_PRIOR)
EZSP_CFG['datamodule'].update({
    'partition_mode': 'contour_prior',
    'pretrained_cnn_ckpt_path': None,
    'pretrained_cnn_channels': [32, 32, 32],
})


# nano-2 (no level 0: its datasets load the NAGs from level 1, whose
# features are the stored segment means; the first stage a transformer
# Stage on level 1) with bf16 compute: configs/train.yaml +
# experiment=semantic/s3dis_nano (NANO_CFG) and + experiment=panoptic/
# s3dis_nano (PANOPTIC_NANO_CFG)
_NANO_DATAMODULE = {
    'nano': True,
    'point_hf': [],
    'segment_mean_hf': ['linearity', 'planarity', 'scattering',
                        'verticality', 'elevation', 'rgb'],
}
_NANO_MODEL = {
    '_point_mlp': None,
    '_node_mlp_out': None,
    '_h_edge_mlp_out': 16,
    '_down_dim': [32, 32],
    '_up_dim': [32],
    'optimizer': {'lr': 0.01, 'weight_decay': '1e-4'},
}
NANO_CFG = copy.deepcopy(FLAGSHIP_CFG)
PANOPTIC_NANO_CFG = copy.deepcopy(PANOPTIC_CFG)
for _cfg in (NANO_CFG, PANOPTIC_NANO_CFG):
    _cfg['datamodule'].update(copy.deepcopy(_NANO_DATAMODULE))
    _cfg['model'].update(copy.deepcopy(_NANO_MODEL))
    _cfg['model']['net'].update({'nano': True, 'down_num_heads': 8})

# SPT-3 (three down stages, two up stages of 64 channels, bf16) on the
# aerial and street datasets and, with SuperCluster's head, on ScanNet:
# configs/train.yaml + experiment=semantic/dales (DALES_CFG),
# semantic/kitti360 (KITTI360_CFG) and panoptic/scannet
# (PANOPTIC_SCANNET_CFG)
_SPT3 = {'_down_dim': [64, 64, 64], '_up_dim': [64, 64],
         'optimizer': {'lr': 0.01, 'weight_decay': '1e-4'}}
_GEOMETRY_HF = ['linearity', 'planarity', 'scattering', 'verticality',
                'elevation']
_OUTDOOR = {
    'in_memory': False, 'dataloader': {'batch_size': 4, 'num_workers': 0},
    'knn': 25, 'knn_r': 10, 'pcp_regularization': [0.1, 0.2, 0.3],
    'pcp_spatial_weight': [0.1, 0.01, 0.001], 'pcp_cutoff': [10, 30, 100],
    'graph_gap': [5, 30, 30]}
DALES_CFG = copy.deepcopy(FLAGSHIP_CFG)
DALES_CFG['datamodule'].update(copy.deepcopy(_OUTDOOR))
DALES_CFG['datamodule'].update({
    'dataset': 'dales', 'num_classes': 8, 'voxel': 0.1,
    'partition_hf': ['intensity'] + _GEOMETRY_HF,
    'point_hf': ['intensity'] + _GEOMETRY_HF})
KITTI360_CFG = copy.deepcopy(FLAGSHIP_CFG)
KITTI360_CFG['datamodule'].update(copy.deepcopy(_OUTDOOR))
KITTI360_CFG['datamodule'].update({
    'dataset': 'kitti360', 'num_classes': 15, 'voxel': 0.05,
    'point_hf': ['rgb'] + _GEOMETRY_HF})
PANOPTIC_SCANNET_CFG = copy.deepcopy(PANOPTIC_CFG)
PANOPTIC_SCANNET_CFG['datamodule'].update({
    'dataset': 'scannet', 'num_classes': 20, 'stuff_classes': [0, 1],
    'in_memory': False, 'dataloader': {'batch_size': 4, 'num_workers': 0},
    'point_hf': ['rgb'] + _GEOMETRY_HF})
for _cfg, _epochs in ((DALES_CFG, 400), (KITTI360_CFG, 200),
                      (PANOPTIC_SCANNET_CFG, 100)):
    _cfg['model'].update(copy.deepcopy(_SPT3))
    _cfg['trainer']['max_epochs'] = _epochs


def _dims(keys):
    return sum(FEAT_SIZE[k] for k in keys)


def _device(device, fn):
    """`device` as a torch.device; a CUDA device must exist (no fallback
    to the CPU)."""
    device = torch.device(device)
    if device.type == 'cuda' and not torch.cuda.is_available():
        raise RuntimeError(f'{fn}: no CUDA device; pass device="cpu" to '
                           'build on the CPU')
    return device


def build_model(cfg, num_graphs=8, compute_dtype='auto',
                plain_attention=False, device='cuda', shard_group=None):
    """Build the SPT backbone of `cfg` (a nested dict shaped like
    `FLAGSHIP_CFG`) on `device`, deriving every channel width as the JAX
    `build_model` does. `compute_dtype='auto'` reads `trainer.precision`.
    `plain_attention` runs the attention kernel's plain PyTorch version
    (for comparing the kernel with it). `shard_group` builds the model for
    one rank's shard of a graph-partition-sharded batch
    (`parallel/mesh.py:make_sharded_forward`). Raises without a CUDA device
    unless `device` is the CPU."""
    device = _device(device, 'build_model')
    dm, m = cfg['datamodule'], cfg['model']
    net = m['net']
    if compute_dtype == 'auto':
        compute_dtype = precision_to_dtype(
            cfg.get('trainer', {}).get('precision'))
    nano = bool(net['nano'])
    use_pos = bool(net['use_pos'])
    use_diam = bool(net['use_diameter'])
    use_diam_p = bool(net['use_diameter_parent'])
    use_node_hf = bool(net['use_node_hf'])

    num_hf_point = _dims(dm['point_hf'])
    num_hf_segment = _dims(list(dm['segment_base_hf'])
                           + ['mean_' + k for k in dm['segment_mean_hf']]
                           + ['std_' + k for k in dm['segment_std_hf']])
    num_hf_edge = _dims(dm['edge_hf'])
    num_hf_v_edge = _dims(dm['v_edge_hf'])

    node_mlp_out = m.get('_node_mlp_out')
    h_edge_mlp_out = m.get('_h_edge_mlp_out')
    v_edge_mlp_out = m.get('_v_edge_mlp_out')
    node_hf_dim = num_hf_segment if use_node_hf else 0
    with_node_mlp = bool(node_mlp_out and use_node_hf and node_hf_dim > 0)
    node_injection = (3 * use_pos + use_diam + use_diam_p
                      + (node_mlp_out if with_node_mlp else node_hf_dim))

    depth = int(m.get('_mlp_depth', 2))
    down_dim, up_dim = list(m['_down_dim']), list(m['_up_dim'])
    point_mlp = m.get('_point_mlp')
    if nano:
        # the first stage reads level 1's own features: the node
        # injection, plus the raw segment features when they are not
        # already part of it
        first_in = node_injection + (0 if use_node_hf else num_hf_segment)
    else:
        first_in = node_injection + point_mlp[-1]
    down_in_mlp = [[first_in if i == 0 else node_injection + down_dim[i - 1]]
                   + [d] * depth for i, d in enumerate(down_dim)]
    up_in_mlp = []
    for i, d in enumerate(up_dim):
        prev = down_dim[-1] if i == 0 else up_dim[i - 1]
        skip = down_dim[-(2 + i)]
        up_in_mlp.append([node_injection + prev + skip] + [d] * depth)

    node_mlp = [node_hf_dim] + [node_mlp_out] * depth \
        if with_node_mlp else None
    h_edge_mlp = [num_hf_edge] + [h_edge_mlp_out] * depth \
        if h_edge_mlp_out and num_hf_edge > 0 else None
    v_edge_mlp = [num_hf_v_edge] + [v_edge_mlp_out] * depth \
        if v_edge_mlp_out and num_hf_v_edge > 0 else None
    in_rpe_dim = h_edge_mlp_out if h_edge_mlp else num_hf_edge

    return SPT(
        point_mlp=(None if nano else [num_hf_point + 3 * use_pos
                                      + use_diam_p] + list(point_mlp)),
        nano=nano, down_dim=down_dim, down_in_mlp=down_in_mlp,
        down_num_heads=int(net['down_num_heads']),
        down_num_blocks=int(net['down_num_blocks']),
        down_ffn_ratio=float(net['down_ffn_ratio']),
        up_dim=up_dim, up_in_mlp=up_in_mlp,
        up_num_heads=int(net['up_num_heads']),
        up_num_blocks=int(net['up_num_blocks']),
        up_ffn_ratio=float(net['up_ffn_ratio']),
        node_mlp=node_mlp, h_edge_mlp=h_edge_mlp, v_edge_mlp=v_edge_mlp,
        qk_dim=int(net['qk_dim']), qkv_bias=bool(net['qkv_bias']),
        qk_scale=net['qk_scale'], in_rpe_dim=int(in_rpe_dim),
        pre_norm=bool(net['pre_norm']), no_sa=bool(net['no_sa']),
        no_ffn=bool(net['no_ffn']), k_rpe=bool(net['k_rpe']),
        q_rpe=bool(net['q_rpe']), v_rpe=bool(net['v_rpe']),
        qk_share_rpe=bool(net['qk_share_rpe']),
        q_on_minus_rpe=bool(net['q_on_minus_rpe']),
        heads_share_rpe=bool(net['heads_share_rpe']),
        use_pos=use_pos, use_node_hf=use_node_hf, use_diameter=use_diam,
        use_diameter_parent=use_diam_p, pool=str(net['pool']),
        fusion=str(net['fusion']), norm_mode=str(net['norm_mode']),
        num_graphs=num_graphs,
        compute_dtype=compute_dtype, plain_attention=plain_attention,
        shard_group=shard_group, device=device)


def build_task(cfg, num_graphs=8, total_steps=100_000, class_weight=None,
               compute_dtype='auto', plain_attention=False, device='cuda',
               shard_group=None):
    """The task of `cfg` (a nested dict shaped like `FLAGSHIP_CFG`) around
    `build_model(cfg, ...)` on `device`: the `SemanticTask`, or the
    `PanopticTask` where `model.task` is 'panoptic' (as `PANOPTIC_CFG`
    sets it), with its edge-affinity loss weight and case weights and
    the datamodule's stuff classes. Both take the loss type and stage
    weights, AdamW's LR and weight decay, the attention LR scale and the
    warm-up, the scheduler (`model.scheduler._target_`: the plateau one
    where it names it, else cosine) and `trainer.accumulate_grad_batches`.
    Numbers may be strings, as the YAML loader gives `1e-2`.

    Where `model.task` is 'partition' (EZ-SP's stage 1), the
    `PartitionTask` around a `PartitionModel` of widths
    `[cnn_width] * cnn_depth + [cnn_out]` over the `datamodule.point_hf`
    features, drawn from a generator seeded with `cfg.seed`, with the
    criterion's keys, the LR and the weight decay; `compute_dtype` and
    `plain_attention` do not apply to it. `shard_group` goes to
    `build_model`. Raises without a CUDA device unless `device` is the
    CPU."""
    device = _device(device, 'build_task')
    m = cfg['model']
    task_type = str(m.get('task', 'semantic'))
    if task_type == 'partition':
        return _partition_task(cfg, num_graphs, total_steps, device)
    if task_type not in ('semantic', 'panoptic'):
        raise ValueError(f'unknown model.task {task_type!r}')
    sched = m['scheduler']
    net = build_model(cfg, num_graphs=num_graphs,
                      compute_dtype=compute_dtype,
                      plain_attention=plain_attention, device=device,
                      shard_group=shard_group)
    common = dict(
        num_classes=int(cfg['datamodule']['num_classes']),
        loss_type=str(m['loss_type']),
        multi_stage_loss_lambdas=tuple(
            float(x) for x in m['multi_stage_loss_lambdas']),
        lr=float(m['optimizer']['lr']),
        weight_decay=float(m['optimizer']['weight_decay']),
        transformer_lr_scale=float(m['transformer_lr_scale']),
        total_steps=total_steps, warmup_steps=int(sched['num_warmup']),
        warmup_init_lr=float(sched['warmup_init_lr']),
        eta_min=float(sched['eta_min']), class_weight=class_weight,
        scheduler=('plateau' if 'plateau' in str(
            sched.get('_target_', 'cosine')).lower() else 'cosine'),
        accumulate_grad_batches=int(
            (cfg.get('trainer') or {}).get('accumulate_grad_batches', 1)))
    if task_type == 'panoptic':
        return PanopticTask(
            net, edge_affinity_loss_lambda=float(
                m.get('edge_affinity_loss_lambda', 1.0)),
            edge_affinity_loss_weights=tuple(
                float(w) for w in m.get('edge_affinity_loss_weights',
                                        (1., 1., 1., 1.))),
            stuff_classes=tuple(
                int(c) for c in cfg['datamodule'].get('stuff_classes', ())),
            **common)
    return SemanticTask(net, **common)


def _partition_task(cfg, num_graphs, total_steps, device):
    """EZ-SP's stage-1 task of `cfg` (see `build_task`)."""
    m, dm = cfg['model'], cfg['datamodule']
    crit = m.get('partition_criterion') or {}
    channels = [int(m['cnn_width'])] * int(m['cnn_depth']) \
        + [int(m['cnn_out'])]
    ratio = crit.get('adaptive_sampling_ratio', 0.9)
    model = PartitionModel(
        _dims(dm['point_hf']), channels=channels, num_graphs=num_graphs,
        device=device, generator=torch.Generator().manual_seed(
            int(cfg.get('seed', 0))))
    return PartitionTask(
        model, num_classes=int(dm['num_classes']),
        affinity_temperature=float(crit.get('affinity_temperature', 1.0)),
        adaptive_sampling_ratio=None if ratio is None else float(ratio),
        focal_gamma=float(crit.get('gamma', 1.0)),
        lr=float(m['optimizer']['lr']),
        weight_decay=float(m['optimizer']['weight_decay']),
        total_steps=total_steps)


def _segment_hf(dm):
    return (list(dm['segment_base_hf'])
            + ['mean_' + k for k in dm['segment_mean_hf']]
            + ['std_' + k for k in dm['segment_std_hf']])


def build_batch_config(cfg):
    """The `BatchConfig` of `cfg`'s datamodule: features, sampling and
    augmentation of the batches, as the JAX `build_batch_config`."""
    dm = cfg['datamodule']
    return BatchConfig(
        num_classes=int(dm['num_classes']),
        point_hf=tuple(dm['point_hf']),
        segment_hf=tuple(_segment_hf(dm)),
        edge_hf=tuple(dm['edge_hf']),
        v_edge_hf=tuple(dm['v_edge_hf']),
        use_mean_normal='normal' in dm['segment_mean_hf'],
        sample_point_min=int(dm['sample_point_min']),
        sample_point_max=int(dm['sample_point_max']),
        sample_graph_r=float(dm['sample_graph_r']),
        sample_graph_k=int(dm['sample_graph_k']),
        sample_graph_max_nodes=int(dm['sample_graph_max_nodes']),
        sample_segment_ratio=float(dm['sample_segment_ratio']),
        sample_segment_by_size=bool(dm['sample_segment_by_size']),
        sample_edge_n_max=int(dm['sample_edge_n_max']),
        max_num_nodes=int(dm['max_num_nodes']),
        max_num_edges=int(dm['max_num_edges']),
        pos_jitter=float(dm['pos_jitter']),
        voxel=float(dm['voxel']),
        tilt_n_rotate_phi=float(dm['tilt_n_rotate_phi']),
        tilt_n_rotate_theta=float(dm['tilt_n_rotate_theta']),
        anisotropic_scaling=float(dm['anisotropic_scaling']),
        node_feat_jitter=float(dm['node_feat_jitter']),
        h_edge_feat_jitter=float(dm['h_edge_feat_jitter']),
        rgb_autocontrast=float(dm['rgb_autocontrast']),
        rgb_drop=float(dm['rgb_drop']),
        nano=bool(dm['nano']),
        instance=bool(dm.get('instance', False)),
        instance_k_max=int(dm.get('instance_k_max', 30)),
        instance_radius=float(dm.get('instance_radius', 0.1)))


def _pre_transform_config(cfg):
    """The `preprocess_cloud` keyword arguments of `cfg`'s datamodule,
    as the JAX `_pre_transform_config` builds them: their repr keys the
    processed files' hash, so it must stay the same dict."""
    dm = cfg['datamodule']
    out = dict(
        voxel=float(dm['voxel']), knn=int(dm['knn']),
        knn_r=float(dm['knn_r']),
        knn_step=int(dm.get('knn_step', -1)),
        knn_min_search=int(dm.get('knn_min_search', 25)),
        knn_backend=str(dm.get('knn_backend', 'host')),
        partition_hf=tuple(dm['partition_hf']),
        point_hf_preprocess=tuple(sorted(
            set(list(dm['point_hf']) + list(dm['partition_hf'])
                + ['normal']) - {'rgb', 'intensity', 'elevation'})),
        pcp_regularization=tuple(dm['pcp_regularization']),
        pcp_spatial_weight=tuple(dm['pcp_spatial_weight']),
        pcp_cutoff=tuple(dm['pcp_cutoff']),
        pcp_k_adjacency=int(dm['pcp_k_adjacency']),
        pcp_w_adjacency=float(dm['pcp_w_adjacency']),
        graph_k_min=int(dm['graph_k_min']),
        graph_k_max=int(dm['graph_k_max']),
        graph_gap=tuple(dm['graph_gap']),
        ground_threshold=float(dm['ground_threshold']),
        ground_scale=float(dm['ground_scale']),
        segment_mean_hf=tuple(dm['segment_mean_hf']),
        segment_std_hf=tuple(dm['segment_std_hf']))
    if dm.get('instance'):
        # instance-aware preprocessing caches separately
        out['with_instances'] = True
    if str(dm.get('graph_builder', 'radius')) != 'radius':
        out['graph_builder'] = str(dm['graph_builder'])
        out['graph_delaunay_max_dist'] = dm.get(
            'graph_delaunay_max_dist', -1)
    # EZ-SP's stage 2: the learned partition. Added only when requested,
    # so the default hashes stay JAX's; the CNN's device is no part of it.
    mode = str(dm.get('partition_mode', 'cut_pursuit'))
    if mode != 'cut_pursuit':
        out.update(
            partition_mode=mode,
            pretrained_cnn_ckpt_path=dm.get('pretrained_cnn_ckpt_path'),
            pretrained_cnn_channels=tuple(dm.get(
                'pretrained_cnn_channels', (32, 32, 32))),
            contour_prior_reg=dm.get('contour_prior_reg', 2e-2),
            contour_prior_min_size=tuple(dm.get(
                'contour_prior_min_size', (5, 30, 90))),
            contour_prior_edge_weight_mode=str(dm.get(
                'contour_prior_edge_weight_mode',
                'exp_neg_latent_distance')),
            contour_prior_k_isolated=int(dm.get(
                'contour_prior_k_isolated', 5)))
    return out


def build_datasets(cfg, stages=('train', 'val', 'test')):
    """{stage: dataset} of `cfg`'s datamodule (`s3dis`, `s3dis_room`,
    `dales`, `kitti360` or `scannet`, the Mini variants where `mini` is
    set), as the JAX `build_datasets`: the same class and keyword
    arguments, `fold` for the S3DIS datasets only. The datasets run
    EZ-SP's frozen CNN, where their preprocessing needs it, on
    `cfg.device` (the card where unset)."""
    from .datasets import (DALES, KITTI360, S3DIS, MiniDALES, MiniKITTI360,
                           MiniS3DIS, MiniS3DISRoom, MiniScanNet, S3DISRoom,
                           ScanNet)
    dm = cfg['datamodule']
    name = str(dm['dataset'])
    full, mini = {'s3dis': (S3DIS, MiniS3DIS),
                  's3dis_room': (S3DISRoom, MiniS3DISRoom),
                  'dales': (DALES, MiniDALES),
                  'kitti360': (KITTI360, MiniKITTI360),
                  'scannet': (ScanNet, MiniScanNet)}[name]
    cls = mini if bool(dm.get('mini', False)) else full
    kwargs = dict(
        pre_transform_config=_pre_transform_config(cfg),
        in_memory=bool(dm.get('in_memory', False)),
        nano=bool(dm.get('nano', False)),
        num_workers=int(dm.get('num_workers', 1)),
        # panoptic configs read gt instances from the raw data
        instances=bool(dm.get('instance', False)),
        # EZ-SP's frozen CNN in stage-2 preprocessing: the run's device
        device=cfg.get('device'))
    if dm.get('xy_tiling'):
        t = dm['xy_tiling']
        kwargs['xy_tiling'] = tuple(t) if not np.isscalar(t) else int(t)
    if dm.get('pc_tiling'):
        kwargs['pc_tiling'] = int(dm['pc_tiling'])
    if name in ('s3dis', 's3dis_room'):
        kwargs['fold'] = int(dm.get('fold', 5))
    return {s: cls(dm['data_dir'], stage=s, **kwargs) for s in stages}
