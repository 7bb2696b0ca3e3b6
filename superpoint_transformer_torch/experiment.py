"""Model and task construction: config -> SPT backbone -> semantic task.

Counterpart of `build_model` and `build_task` (semantic) in
`superpoint_transformer_tpu/experiment.py` over a plain nested dict.
`FLAGSHIP_CFG` holds the values that they read from `configs/train.yaml`
composed with `experiment=semantic/s3dis`, so no YAML reader is needed; a
test pins it to the YAML.
"""
from .models.semantic import SemanticTask
from .models.spt import SPT

__all__ = ['FEAT_SIZE', 'FLAGSHIP_CFG', 'build_model', 'build_task',
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

# SPT-2 on S3DIS with bf16 compute: the values build_model and build_task
# read from configs/train.yaml + experiment=semantic/s3dis
FLAGSHIP_CFG = {
    'datamodule': {
        'num_classes': 13,
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
    'trainer': {'precision': 'bf16'},
}


def _dims(keys):
    return sum(FEAT_SIZE[k] for k in keys)


def build_model(cfg, num_graphs=8, compute_dtype='auto',
                plain_attention=False, device=None):
    """Build the SPT backbone of `cfg` (a nested dict shaped like
    `FLAGSHIP_CFG`), deriving every channel width as the JAX
    `build_model` does. `compute_dtype='auto'` reads `trainer.precision`.
    `plain_attention` runs the attention kernel's plain PyTorch version
    (for comparing the kernel with it)."""
    dm, m = cfg['datamodule'], cfg['model']
    net = m['net']
    if compute_dtype == 'auto':
        compute_dtype = precision_to_dtype(
            cfg.get('trainer', {}).get('precision'))
    if net['nano']:
        raise NotImplementedError('nano SPT (no level 0) is not ported')
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
    point_out = m['_point_mlp'][-1]
    down_in_mlp = [[node_injection + (point_out if i == 0
                                      else down_dim[i - 1])] + [d] * depth
                   for i, d in enumerate(down_dim)]
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
        point_mlp=[num_hf_point + 3 * use_pos + use_diam_p]
        + list(m['_point_mlp']),
        down_dim=down_dim, down_in_mlp=down_in_mlp,
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
        device=device)


def build_task(cfg, num_graphs=8, total_steps=100_000, class_weight=None,
               compute_dtype='auto', plain_attention=False, device=None):
    """The semantic `SemanticTask` of `cfg` (a nested dict shaped like
    `FLAGSHIP_CFG`) around `build_model(cfg, ...)` on `device`: its loss
    type and stage weights, AdamW's LR and weight decay, the attention
    LR scale and the warm-up. Numbers may be strings, as the YAML loader
    gives `1e-2`. Gradient accumulation and the plateau scheduler are not
    ported."""
    m = cfg['model']
    sched = m['scheduler']
    if 'plateau' in str(sched.get('_target_', 'cosine')).lower():
        raise NotImplementedError('the plateau scheduler is not ported')
    if int(cfg.get('trainer', {}).get('accumulate_grad_batches', 1)) != 1:
        raise NotImplementedError('gradient accumulation is not ported')
    net = build_model(cfg, num_graphs=num_graphs,
                      compute_dtype=compute_dtype,
                      plain_attention=plain_attention, device=device)
    return SemanticTask(
        net, num_classes=int(cfg['datamodule']['num_classes']),
        loss_type=str(m['loss_type']),
        multi_stage_loss_lambdas=tuple(
            float(x) for x in m['multi_stage_loss_lambdas']),
        lr=float(m['optimizer']['lr']),
        weight_decay=float(m['optimizer']['weight_decay']),
        transformer_lr_scale=float(m['transformer_lr_scale']),
        total_steps=total_steps, warmup_steps=int(sched['num_warmup']),
        warmup_init_lr=float(sched['warmup_init_lr']),
        eta_min=float(sched['eta_min']), class_weight=class_weight)
