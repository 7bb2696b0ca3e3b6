"""The rulebook of a submanifold sparse convolution, built on the host.

Counterpart of `superpoint_transformer_tpu/ops/voxel_conv.py`, numpy
only. For every active voxel the table holds the index of the active
voxel at each of the K^3 kernel offsets, or -1 for an empty site: one
sorted join per batch, shared by every block of the sparse CNN
(`nn/sparse.py`), which then convolves with one gather and one matmul.
Voxel coordinates become int64 keys, sorted once; each offset is one
`searchsorted` over the sorted keys. Voxels of different graphs never
meet: the graph id offsets the key past the span of every coordinate.
"""
import numpy as np

__all__ = ['build_sparse_conv_neighbors', 'kernel_offsets']


def kernel_offsets(kernel_size=3, dilation=1):
    """[K^3, 3] integer offsets of a centered cubic kernel, scaled by
    `dilation` (output sites are the input sites)."""
    k = int(kernel_size)
    r = np.arange(k) - (k - 1) // 2
    off = np.stack(np.meshgrid(r, r, r, indexing='ij'),
                   axis=-1).reshape(-1, 3)
    return off * int(dilation)


def build_sparse_conv_neighbors(coords, kernel_size=3, dilation=1,
                                batch=None):
    """[N, K^3] int32: for each voxel of `coords` [N, 3] (integer, unique
    within a graph), the row of the voxel at each kernel offset, -1
    where that site is empty. `batch` [N] (graph ids), where given, keeps
    each voxel's neighbors within its graph."""
    coords = np.asarray(coords, dtype=np.int64)
    n = coords.shape[0]
    off = kernel_offsets(kernel_size, dilation)
    K = off.shape[0]
    if n == 0:
        return np.zeros((0, K), dtype=np.int32)

    c = coords - coords.min(axis=0)
    span = c.max(axis=0) + 2 * np.abs(off).max() + 2
    mult = np.array([span[1] * span[2], span[2], 1], dtype=np.int64)
    # shift so that every offset key stays nonnegative
    c = c + int(np.abs(off).max())
    keys = c @ mult
    if batch is not None:
        keys = keys + np.asarray(batch, dtype=np.int64) * int(
            span.prod() + 1)
    order = np.argsort(keys)
    sorted_keys = keys[order]

    nbr = np.empty((n, K), dtype=np.int32)
    for j in range(K):
        qk = keys + off[j] @ mult
        pos = np.clip(np.searchsorted(sorted_keys, qk), 0, n - 1)
        hit = sorted_keys[pos] == qk
        nbr[:, j] = np.where(hit, order[pos], -1).astype(np.int32)
    return nbr
