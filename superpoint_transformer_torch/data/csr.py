"""CSR containers (host side, numpy): `CSRData`, `Cluster` and
`InstanceData`, copies of the JAX package's `data/csr.py`. A `pointers`
array of segment boundaries plus a list of `values` arrays;
`is_index_value` flags which value arrays hold indices (and must be
offset when batching).
"""
import numpy as np

from .io import save_array, load_array

__all__ = ['CSRData', 'Cluster', 'InstanceData']


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


class InstanceData(CSRData):
    """CSR of (cluster -> overlapping ground-truth instances): values are
    (obj id, overlap count, semantic label y) per overlap."""

    def __init__(self, pointers, obj=None, count=None, y=None, dense=False,
                 **kwargs):
        if obj is None:
            super().__init__(pointers, is_index_value=[True, False, False])
        else:
            super().__init__(pointers, obj, count, y,
                             is_index_value=[True, False, False], dense=dense)

    @property
    def obj(self):
        return self.values[0]

    @property
    def count(self):
        return self.values[1]

    @property
    def y(self):
        return self.values[2]

    @classmethod
    def load(cls, f, non_fp_to_long=False):
        base = CSRData.load.__func__(CSRData, f, non_fp_to_long=True)
        return cls(base.pointers, *base.values)

    def merge(self, idx):
        """Re-aggregate the overlaps after clusters are merged: `idx` maps
        each current cluster to its new (merged) cluster id."""
        idx = np.asarray(idx, dtype=np.int64)
        num_new = int(idx.max()) + 1 if idx.size else 0
        cluster_of_item = idx[self.to_super_index()]
        # merge duplicate (cluster, obj) pairs, summing counts
        key = cluster_of_item * (int(self.obj.max()) + 1 if self.obj.size
                                 else 1) + self.obj
        uniq, inv = np.unique(key, return_inverse=True)
        counts = np.zeros(uniq.shape[0], dtype=np.int64)
        np.add.at(counts, inv, self.count)
        order = np.argsort(inv, kind='stable')
        first = order[np.searchsorted(inv[order], np.arange(uniq.shape[0]))]
        new_cluster = cluster_of_item[first]
        new_obj = self.obj[first]
        new_y = self.y[first]
        # sort by cluster then rebuild the CSR
        sort = np.argsort(new_cluster, kind='stable')
        new_cluster = new_cluster[sort]
        ptr = np.zeros(num_new + 1, dtype=np.int64)
        np.cumsum(np.bincount(new_cluster, minlength=num_new), out=ptr[1:])
        return InstanceData(
            ptr, new_obj[sort], counts[sort], new_y[sort])

    @classmethod
    def cat(cls, objs):
        """Concatenate per-cloud InstanceData, offsetting the object ids
        so that instances of different scenes never collide."""
        ptr_off = 0
        obj_off = 0
        ptrs, obj_v, cnt_v, y_v = [np.zeros(1, np.int64)], [], [], []
        for o in objs:
            ptrs.append(o.pointers[1:] + ptr_off)
            ptr_off += o.pointers[-1]
            obj_v.append(o.obj + obj_off)
            obj_off += int(o.obj.max()) + 1 if o.obj.size else 0
            cnt_v.append(o.count)
            y_v.append(o.y)
        return cls(np.concatenate(ptrs), np.concatenate(obj_v),
                   np.concatenate(cnt_v), np.concatenate(y_v))

    # the instance operations live in ops.instance (imported lazily: it
    # imports this module)

    @property
    def indices(self):
        """Cluster id per overlap row."""
        return self.to_super_index()

    def iou_and_size(self):
        """(iou, cluster_size, object_size) per overlap; honours the
        `pair_cropped_count` that `remove_void` sets."""
        from ..ops.instance import instance_iou_and_size
        return instance_iou_and_size(
            self, getattr(self, 'pair_cropped_count', None))

    def major(self, num_classes=None):
        """(obj, count, y) of each cluster's majority instance, with the
        fallback for clusters at most half void."""
        from ..ops.instance import instance_major
        return instance_major(self, num_classes=num_classes)

    def search_void(self, num_classes):
        """(is_cluster_void, is_pair_void, pair_cropped_count)."""
        from ..ops.instance import instance_search_void
        return instance_search_void(self, num_classes)

    def remove_void(self, num_classes):
        """(void-free InstanceData, surviving-cluster mask)."""
        from ..ops.instance import instance_remove_void
        return instance_remove_void(self, num_classes)

    def estimate_centroid(self, cluster_pos, mode='iou'):
        """(obj_pos, obj_ids): each object's centroid estimated from the
        clusters that overlap it."""
        from ..ops.instance import estimate_instance_centroid
        return estimate_instance_centroid(self, cluster_pos, mode=mode)

    def instance_graph(self, edge_index, num_classes=None,
                       smooth_affinity=True):
        """(trimmed edge_index, per-edge affinity): the target instance
        graph."""
        from ..ops.instance import instance_graph_affinity
        return instance_graph_affinity(
            self, edge_index, num_classes=num_classes,
            smooth_affinity=smooth_affinity)


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
