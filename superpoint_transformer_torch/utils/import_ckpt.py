"""Import reference Superpoint Transformer checkpoints into the port.

Counterpart of `superpoint_transformer_tpu/utils/import_ckpt.py`: maps
the torch `state_dict` of a reference Lightning checkpoint
(SemanticSegmentationModule over the SPT backbone, reference
src/models/semantic.py:35, src/models/components/spt.py:14) onto a port
module of the same architecture, in place. This is how a user of the
reference serves the weights they trained there.

The port's parameter names are the flax paths (`utils/jax_params.py`),
so a parameter goes to its flax path (`...weight` of a Linear or a
sparse convolution is the flax `kernel`), then to its reference key by
the JAX package's key grammar, copied here (`reference_key_for`):

    ours (flax path)                     reference (torch)
    ------------------------------------ ---------------------------
    head_{i}/classifier/kernel           head.{i}.classifier.weight
    net/first_stage/...                  net.first_stage....
    net/down_stage_{i}/...               net.down_stages.{i}....
    net/up_stage_{i}/...                 net.up_stages.{i}....
    net/node_mlp_{i}|h_edge_mlp_{i}|     net.node_mlps.{i}|
        v_edge_mlp_{i}/...                   h_edge_mlps.{i}|...
    .../in_mlp|out_mlp/linear_{k}        ....in_mlp|out_mlp.mlp.{j}
        (j = k*(3 if normed else 2):         (reference mlp() builds
         Linear/Norm/Activation triples       [Linear, Norm, Act] per
         — src/nn/mlp.py:40-57)               layer in a ModuleList)
    .../norm_{k}                         ....mlp.{j+1} (GraphNorm:
                                              weight/bias/mean_scale)
    .../block_{b}/sa_norm|ffn_norm       ....transformer_blocks.{b}.
                                              sa_norm|ffn_norm
    .../block_{b}/sa/qkv|out_proj|       ....transformer_blocks.{b}.
        k_rpe|q_rpe|v_rpe                     sa.qkv|out_proj|k_rpe|..
    .../ffn/linear_{k}                   ....ffn.mlp.{2k}
    edge_affinity_head/linear_{k}        edge_affinity_head.mlp.{2k}
    cnn/block_{i}/kernel|bias            net.first_stage.cnn_blocks.{i}
        (PartitionModel)                     .conv.kernel|bias
    cnn/block_{i}/GraphNorm_0/...        ....cnn_blocks.{i}.norm....

A reference `nn.Linear.weight` is [out, in], as the port's is: it
crosses without a transpose. A sparse-convolution kernel [K, in, out]
(or [in, out] for a 1x1 convolution) becomes the port's
`SparseConvBlock.weight` [out, K*in]. Norms carry the same parameter
names on both sides.
"""
import re

import numpy as np
import torch

__all__ = ['import_reference_checkpoint', 'reference_key_for', 'flax_path',
           'reference_state_dict']


def _stage_key(name):
    if name == 'first_stage':
        return 'first_stage'
    m = re.fullmatch(r'down_stage_(\d+)', name)
    if m:
        return f'down_stages.{m.group(1)}'
    m = re.fullmatch(r'up_stage_(\d+)', name)
    if m:
        return f'up_stages.{m.group(1)}'
    m = re.fullmatch(r'(node|h_edge|v_edge)_mlp_(\d+)', name)
    if m:
        return f'{m.group(1)}_mlps.{m.group(2)}'
    m = re.fullmatch(r'(node|h_edge|v_edge)_mlp_shared', name)
    if m:
        return f'{m.group(1)}_mlps.0'
    return None


def _mlp_module_index(kind, k, normed):
    """Position of linear_{k} / norm_{k} inside the reference MLP's
    flat ModuleList (Linear[, Norm][, Act] per layer)."""
    per = 3 if normed else 2
    base = per * k
    return base if kind == 'linear' else base + 1


def reference_key_for(path, normed_mlps=True):
    """Reference state_dict key for one flax parameter path (tuple of
    str from the model root, ending with the parameter name). None for
    a parameter with no reference counterpart."""
    path = list(path)
    leaf = path.pop()
    ref_leaf = {'kernel': 'weight'}.get(leaf, leaf)

    # classifier heads live on the task module, not the backbone
    m = re.fullmatch(r'head_(\d+)', path[0]) if path else None
    if m and path[1:] == ['classifier']:
        return f'head.{m.group(1)}.classifier.{ref_leaf}'
    if path and path[0] == 'head' and path[1:] == ['classifier']:
        return f'head.classifier.{ref_leaf}'

    # SuperCluster edge-affinity head: an FFN on the task module
    # (reference src/models/panoptic.py:257-258)
    if path and path[0] == 'edge_affinity_head':
        m = re.fullmatch(r'linear_(\d+)', path[1]) if path[1:] else None
        if m:
            j = _mlp_module_index('linear', int(m.group(1)), normed=False)
            return f'edge_affinity_head.mlp.{j}.{ref_leaf}'
        return None

    # EZ-SP stage-1 PartitionModel: its root is {'cnn': ...}; the
    # reference trains the same weights as net.first_stage.cnn_blocks
    # (reference src/nn/stage.py:714, src/transforms/point.py:724-726)
    if path and path[0] == 'cnn':
        return _cnn_key(['net', 'first_stage'], path[1:], leaf, ref_leaf)

    if not path or path[0] != 'net':
        return None
    parts = ['net']
    i = 1
    stage = _stage_key(path[i])
    if stage is None:
        return None
    parts.append(stage)
    i += 1

    # EZ-SP stage 2: a point stage with a sparse CNN front
    rest = path[i:]
    if rest and rest[0] == 'cnn':
        return _cnn_key(parts, rest[1:], leaf, ref_leaf)

    # hf MLPs: the module IS the MLP; stages nest in_mlp/out_mlp
    if rest and rest[0] in ('in_mlp', 'out_mlp'):
        parts.append(rest[0])
        return _mlp_rest(parts, rest[1:], ref_leaf, normed_mlps)
    if re.fullmatch(r'(node|h_edge|v_edge)_mlps\.\d+', stage):
        return _mlp_rest(parts, rest, ref_leaf, normed_mlps)

    m = re.fullmatch(r'block_(\d+)', rest[0]) if rest else None
    if m:
        parts.append(f'transformer_blocks.{m.group(1)}')
        rest = rest[1:]
        if rest[0] in ('sa_norm', 'ffn_norm'):
            parts.append(rest[0])
            return '.'.join(parts) + '.' + ref_leaf
        if rest[0] == 'sa':
            parts.append('sa')
            parts.append(rest[1])    # qkv|out_proj|k_rpe|q_rpe|v_rpe
            return '.'.join(parts) + '.' + ref_leaf
        if rest[0] == 'ffn':
            parts.append('ffn')
            m2 = re.fullmatch(r'linear_(\d+)', rest[1])
            j = _mlp_module_index('linear', int(m2.group(1)), normed=False)
            parts.append(f'mlp.{j}')
            return '.'.join(parts) + '.' + ref_leaf
    return None


def _cnn_key(parts, rest, leaf, ref_leaf):
    """Sparse-CNN block parameters. Reference layout (src/nn/sparse.py:14
    ConvBlock in the SparseCNN ModuleList): cnn_blocks.{i}.conv
    .kernel|bias (torchsparse's Conv3d parameter is 'kernel') and
    cnn_blocks.{i}.norm.* (GraphNorm). Ours: cnn/block_{i}/kernel|bias
    and its norm submodule GraphNorm_0."""
    if not rest:
        return None
    m = re.fullmatch(r'block_(\d+)', rest[0])
    if not m:
        return None
    base = '.'.join(parts) + f'.cnn_blocks.{m.group(1)}'
    mid = rest[1:]
    if not mid:
        if leaf in ('kernel', 'bias'):
            return f'{base}.conv.{leaf}'
        return None
    if len(mid) == 1 and re.fullmatch(r'[A-Za-z]*Norm_\d+', mid[0]):
        return f'{base}.norm.{ref_leaf}'
    return None


def _mlp_rest(parts, rest, ref_leaf, normed):
    m = re.fullmatch(r'(linear|norm)_(\d+)', rest[0])
    if not m:
        return None
    j = _mlp_module_index(m.group(1), int(m.group(2)), normed)
    parts.append(f'mlp.{j}')
    return '.'.join(parts) + '.' + ref_leaf


def flax_path(name, param):
    """The flax path (tuple of names) of the port parameter `name`: its
    module names, and `kernel` for the [out, in] weight of a Linear or a
    sparse convolution (norm weights are 1-D)."""
    *mods, leaf = name.split('.')
    if leaf == 'weight' and param.dim() == 2:
        leaf = 'kernel'
    return tuple(mods) + (leaf,)


def reference_state_dict(module):
    """The reference-format state_dict of a port `module`, the inverse of
    `import_reference_checkpoint`: each parameter under its reference key
    (ValueError where it has none), Linear weights [out, in] as they are,
    a sparse convolution's weight [out, K*in] as the reference kernel
    [K, in, out]. CPU tensors."""
    from ..nn.sparse import KERNEL_VOLUME
    state = {}
    for name, p in module.named_parameters():
        key = reference_key_for(flax_path(name, p))
        if key is None:
            raise ValueError(f'no reference key for {name}')
        t = p.detach().cpu().clone()
        if key.endswith('.conv.kernel'):
            t = t.t().reshape(KERNEL_VOLUME, -1, t.shape[0]).contiguous()
        state[key] = t
    return state


def _load_state(ckpt):
    if isinstance(ckpt, (str, bytes)) or hasattr(ckpt, '__fspath__'):
        blob = torch.load(ckpt, map_location='cpu', weights_only=False)
        return blob.get('state_dict', blob)
    return ckpt


@torch.no_grad()
def import_reference_checkpoint(ckpt, module, strict=True, verbose=False):
    """Fill the port `module` in place from a reference checkpoint.

    :param ckpt: path to a reference Lightning .ckpt / .pt file (its
        `state_dict`), or a state_dict (name -> tensor or array)
    :param module: the port module of the same architecture
    :param strict: raise ValueError if a parameter of `module` has no
        reference key; otherwise it keeps its value and is reported.
        Nothing is written when it raises
    :return: report {'mapped': port parameter names, 'missing': port
        parameter names without a source, 'unused_reference_keys':
        reference keys nothing took, training state and criterion
        buffers aside}. A shape mismatch raises ValueError either way."""
    state = _load_state(ckpt)
    mapped, missing, used = {}, [], set()
    for name, param in module.named_parameters():
        path = flax_path(name, param)
        key = reference_key_for(path)
        src = state.get(key) if key else None
        if src is None:
            missing.append(name)
            continue
        src = np.asarray(src.detach().cpu().numpy() if torch.is_tensor(src)
                         else src)
        if key.endswith('.conv.kernel'):
            # torchsparse Conv3d kernels: [K, in, out] for K > 1, [in,
            # out] for a 1x1 convolution -> the port's [out, K*in]
            src = src.reshape(-1, src.shape[-1]).T
        if tuple(src.shape) != tuple(param.shape):
            raise ValueError(f'shape mismatch for {name} <- {key}: '
                             f'{tuple(src.shape)} vs {tuple(param.shape)}')
        mapped[name] = (param, src)
        used.add(key)

    ignorable = re.compile(
        r'^(criterion|train_|val_|test_|.*num_batches_tracked'
        r'|.*running_(mean|var))')
    unused = [k for k in state if k not in used and not ignorable.match(k)]
    if missing and strict:
        raise ValueError(f'{len(missing)} parameters with no reference '
                         f'source, e.g. {missing[:5]}')
    # nothing is written before every check passed
    for param, src in mapped.values():
        param.copy_(torch.from_numpy(np.ascontiguousarray(src)).to(
            param.dtype))
    report = {'mapped': sorted(mapped), 'missing': sorted(missing),
              'unused_reference_keys': sorted(unused)}
    if verbose:
        print(f'imported {len(mapped)} tensors; {len(missing)} unmapped '
              f'parameters; {len(unused)} unused reference keys')
    return report
