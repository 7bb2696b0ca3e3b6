"""Load a flax parameter tree into the port's modules.

The port's submodule names are the flax module names, so a flax path
`net/down_stage_0/block_2/sa/qkv/kernel` is the `state_dict` key
`net.down_stage_0.block_2.sa.qkv.weight`. A Dense `kernel` [in, out]
becomes `Linear.weight` [out, in]; every other leaf (biases, the norms'
`weight`, `bias`, `mean_scale`) maps straight across; so does a sparse
convolution's `kernel` [K^3 * in, out] (its `weight` [out, K^3 * in]) and
an attentive pool's learnt query `q`. Nano models follow the same rule:
their `first_stage` is a transformer `Stage` (`first_stage.block_0.
sa...`), and their `node_mlp_*` / `h_edge_mlp_*` run over one more level
than their down stages. A BatchNorm's running statistics, the flax
`batch_stats` collection (`.../norm_0/mean`, `.../var`), are its buffers
`mean` and `var`.
"""
from collections.abc import Mapping

import numpy as np
import torch

__all__ = ['load_jax_params', 'jax_key_for']


def _flatten(tree, prefix=()):
    for k, v in tree.items():
        if isinstance(v, Mapping):
            yield from _flatten(v, prefix + (k,))
        else:
            yield prefix + (k,), v


def jax_key_for(path):
    """`state_dict` key of a flax parameter path (tuple of names)."""
    *mods, leaf = path
    return '.'.join(mods + ['weight' if leaf == 'kernel' else leaf])


def _batch_stat_buffers(module):
    """{state_dict key: buffer} of the running statistics of every
    BatchNorm of `module`."""
    from ..nn.norm import BatchNorm
    out = {}
    for name, m in module.named_modules():
        if isinstance(m, BatchNorm):
            for leaf in ('mean', 'var'):
                out[f'{name}.{leaf}' if name else leaf] = getattr(m, leaf)
    return out


def _copy_tree(tree, state, what):
    seen = set()
    for path, value in _flatten(tree):
        key = jax_key_for(path)
        if key not in state:
            raise KeyError(f'flax {what} {"/".join(path)} has no '
                           f'counterpart {key!r} in the module')
        v = np.asarray(value, dtype=np.float32)
        if path[-1] == 'kernel':
            v = v.T
        p = state[key]
        if tuple(v.shape) != tuple(p.shape):
            raise ValueError(f'{key}: flax shape {v.shape} vs module '
                             f'shape {tuple(p.shape)}')
        p.copy_(torch.from_numpy(np.ascontiguousarray(v)))
        seen.add(key)
    missing = sorted(set(state) - seen)
    if missing:
        raise KeyError(f'module {what}s missing from the flax tree: '
                       f'{missing}')


@torch.no_grad()
def load_jax_params(module, params, batch_stats=None):
    """Copy the flax `params` tree (nested dicts of numpy arrays, e.g.
    `variables['params']`) into `module`, and the `batch_stats` tree
    (`variables['batch_stats']`) into its BatchNorms' running statistics.
    Strict both ways: a parameter (or running statistic) of the module
    with no flax counterpart, or a flax leaf with no parameter, raises
    KeyError; a shape mismatch raises ValueError. A module without
    BatchNorm takes no `batch_stats`."""
    _copy_tree(params, dict(module.named_parameters()), 'parameter')
    stats = _batch_stat_buffers(module)
    if stats or batch_stats:
        _copy_tree(batch_stats or {}, stats, 'running statistic')
    return module
