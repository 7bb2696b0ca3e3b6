"""Load a flax parameter tree into the port's modules.

The port's submodule names are the flax module names, so a flax path
`net/down_stage_0/block_2/sa/qkv/kernel` is the `state_dict` key
`net.down_stage_0.block_2.sa.qkv.weight`. A Dense `kernel` [in, out]
becomes `Linear.weight` [out, in]; every other leaf (biases, the norms'
`weight`, `bias`, `mean_scale`) maps straight across.
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


@torch.no_grad()
def load_jax_params(module, params):
    """Copy the flax `params` tree (nested dicts of numpy arrays, e.g.
    `variables['params']`) into `module`. Strict both ways: a parameter
    of the module with no flax counterpart, or a flax leaf with no
    parameter, raises KeyError; a shape mismatch raises ValueError."""
    state = dict(module.named_parameters())
    seen = set()
    for path, value in _flatten(params):
        key = jax_key_for(path)
        if key not in state:
            raise KeyError(f'flax parameter {"/".join(path)} has no '
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
        raise KeyError(f'module parameters missing from the flax tree: '
                       f'{missing}')
    return module
