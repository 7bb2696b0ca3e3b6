"""CSR containers (host side, numpy): `CSRData` and `Cluster`, copies of
the JAX package's `data/csr.py`. A `pointers` array of segment
boundaries plus a list of `values` arrays; `is_index_value` flags which
value arrays hold indices (and must be offset when batching).
`InstanceData` comes with the panoptic slice.
"""
import numpy as np

from .io import save_array, load_array

__all__ = ['CSRData', 'Cluster']


class CSRData:
    _pointer_key = 'pointers'
    _iiv_key = 'is_index_value'
    _value_prefix = 'value_'

    def __init__(self, pointers, *values, is_index_value=None, dense=False):
        if dense:
            # `pointers` is actually a dense index array to convert
            idx = np.asarray(pointers)
            order = np.argsort(idx, kind='stable')
            counts = np.bincount(idx)
            pointers = np.zeros(counts.shape[0] + 1, dtype=np.int64)
            np.cumsum(counts, out=pointers[1:])
            values = [np.asarray(v)[order] for v in values]
        self.pointers = np.asarray(pointers)
        self.values = [np.asarray(v) for v in values]
        if is_index_value is None:
            is_index_value = np.zeros(len(self.values), dtype=bool)
        self.is_index_value = np.asarray(is_index_value, dtype=bool)

    @property
    def num_groups(self):
        return self.pointers.shape[0] - 1

    @property
    def num_items(self):
        return int(self.pointers[-1])

    @property
    def num_values(self):
        return len(self.values)

    @property
    def sizes(self):
        return np.diff(self.pointers)

    def to_super_index(self):
        """Dense group id for each item."""
        return np.repeat(
            np.arange(self.num_groups, dtype=np.int64), self.sizes)

    def __getitem__(self, idx):
        """Select groups by (int/array/bool) index, rebuilding compact
        pointers. Returns (selection, item ids of the selection)."""
        idx = _as_index(idx)
        sizes = self.sizes[idx]
        new_ptr = np.zeros(idx.shape[0] + 1, dtype=np.int64)
        np.cumsum(sizes, out=new_ptr[1:])
        starts = self.pointers[idx]
        item_idx = np.repeat(starts, sizes) + _ranges(sizes)
        values = [v[item_idx] for v in self.values]
        return type(self)(
            new_ptr, *values, is_index_value=self.is_index_value), item_idx

    def save(self, f, fp_dtype=np.float32):
        save_array(self.pointers, f, self._pointer_key, fp_dtype=fp_dtype)
        save_array(self.is_index_value.astype(np.uint8), f, self._iiv_key,
                   fp_dtype=fp_dtype)
        for i, v in enumerate(self.values):
            save_array(v, f, f'{self._value_prefix}{i}', fp_dtype=fp_dtype)

    @classmethod
    def load(cls, f, non_fp_to_long=False):
        pointers = load_array(f, cls._pointer_key).astype(np.int64)
        iiv = f[cls._iiv_key][:].astype(bool) if cls._iiv_key in f else None
        values = []
        i = 0
        while f'{cls._value_prefix}{i}' in f:
            values.append(load_array(f, f'{cls._value_prefix}{i}',
                                     non_fp_to_long=non_fp_to_long))
            i += 1
        return cls(pointers, *values, is_index_value=iiv)

    def __repr__(self):
        return (f'{type(self).__name__}(num_groups={self.num_groups}, '
                f'num_items={self.num_items}, num_values={self.num_values})')


class Cluster(CSRData):
    """CSR of cluster -> point indices. values[0] = point indices."""

    def __init__(self, pointers, points=None, dense=False, **kwargs):
        if points is None:
            # loading path via CSRData.load passes values positionally
            super().__init__(pointers, is_index_value=[True], dense=dense)
        else:
            super().__init__(pointers, points, is_index_value=[True],
                             dense=dense)

    @property
    def points(self):
        return self.values[0]

    def to_super_index(self):
        """Inverse map: for each point, its cluster id. Assumes points
        form a permutation of [0, num_points)."""
        out = np.empty(self.num_items, dtype=np.int64)
        out[self.points] = np.repeat(
            np.arange(self.num_groups, dtype=np.int64), self.sizes)
        return out

    @classmethod
    def load(cls, f, non_fp_to_long=False):
        base = CSRData.load.__func__(CSRData, f, non_fp_to_long=True)
        return cls(base.pointers, base.values[0])


def _as_index(idx):
    idx = np.asarray(idx)
    if idx.dtype == bool:
        idx = np.where(idx)[0]
    if idx.ndim == 0:
        idx = idx.reshape(1)
    return idx


def _ranges(sizes):
    """Concatenated aranges: [0..s0-1, 0..s1-1, ...]."""
    total = int(sizes.sum())
    if total == 0:
        return np.zeros(0, dtype=np.int64)
    starts = np.zeros(sizes.shape[0], dtype=np.int64)
    np.cumsum(sizes[:-1], out=starts[1:])
    return np.arange(total, dtype=np.int64) - np.repeat(starts, sizes)
