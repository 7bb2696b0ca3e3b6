"""Debug mode: opt-in structural checks of the host containers, the
counterpart of `superpoint_transformer_tpu/debug.py` (reference
src/debug.py `set_debug` and the `self.debug()` validations of the data
structures, src/data/data.py:61, nag.py:52, csr.py:96).

With debug on, every `Data` and `NAG` the port builds is validated, and
a broken one raises ValueError:

    import superpoint_transformer_torch as spt
    spt.set_debug(True)
"""
import numpy as np

__all__ = ['set_debug', 'is_debug_enabled', 'validate_data',
           'validate_nag', 'validate_csr']

_DEBUG = False


def set_debug(flag=True):
    global _DEBUG
    _DEBUG = bool(flag)


def is_debug_enabled():
    return _DEBUG


def _check(cond, msg):
    if not cond:
        raise ValueError(msg)


def validate_csr(csr):
    """Pointers: 1-D, from 0, non-decreasing; every value array holds
    `pointers[-1]` items."""
    ptr = np.asarray(csr.pointers)
    _check(ptr.ndim == 1 and ptr.shape[0] >= 1, 'bad pointers shape')
    _check(ptr[0] == 0, 'pointers must start at 0')
    _check((np.diff(ptr) >= 0).all(), 'pointers must be nondecreasing')
    for v in csr.values:
        _check(v.shape[0] == ptr[-1],
               f'value length {v.shape[0]} != num_items {ptr[-1]}')


def validate_data(data):
    """Node attributes of one length, edges and `super_index` in range,
    histograms non-negative, `sub` a valid CSR with a group per node."""
    n = data.num_nodes
    for k in data.node_attrs():
        v = data[k]
        if hasattr(v, 'shape'):
            _check(v.shape[0] == n, f'{k}: {v.shape[0]} != {n} nodes')
    ei = data.get('edge_index')
    if ei is not None and ei.size:
        _check(ei.min() >= 0 and ei.max() < n, 'edge index out of range')
    si = data.get('super_index')
    if si is not None and si.size:
        _check(si.min() >= 0, 'negative super_index')
    y = data.get('y')
    if y is not None and y.ndim == 2:
        _check((np.asarray(y) >= 0).all(), 'negative histogram counts')
    sub = data.get('sub')
    if sub is not None:
        validate_csr(sub)
        _check(sub.num_groups == n, 'sub groups != nodes')


def validate_nag(nag):
    """Every level valid, and each level's `super_index` below the next
    level's node count."""
    for i in nag.levels:
        validate_data(nag[i])
    for i in nag.levels[:-1]:
        si = nag[i].get('super_index')
        if si is not None and si.size:
            _check(int(si.max()) < nag[i + 1].num_nodes,
                   f'level {i} super_index exceeds level {i + 1} size')
