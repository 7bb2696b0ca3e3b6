"""NAG, the Nested Acyclic Graph of a hierarchical partition: a copy of
the JAX package's `data/nag.py`. A list of `Data` levels, level 0 =
voxels/points, levels 1..k = superpoints, linked by `super_index`
(child -> parent) and `sub` (parent -> children Cluster).
`start_i_level > 0` marks nano models that skip level 0. h5py is
imported only by `save` and `load`.
"""
import numpy as np

from ..debug import is_debug_enabled, validate_nag
from .csr import Cluster
from .data import Data

__all__ = ['NAG']


class NAG:
    _start_key = 'start_i_level'
    _level_prefix = 'level_'

    def __init__(self, data_list, start_i_level=0):
        self._list = list(data_list)
        self.start_i_level = int(start_i_level)
        if is_debug_enabled():
            validate_nag(self)

    # -- level access: ABSOLUTE level indexing -------------------------
    def __getitem__(self, i):
        j = i - self.start_i_level
        if j < 0:
            # without this guard, `nag[0]` on a partially-loaded NAG
            # (start_i_level=1) would silently wrap to the LAST level
            raise IndexError(
                f'level {i} not loaded (start_i_level='
                f'{self.start_i_level})')
        return self._list[j]

    def __iter__(self):
        # explicit: default __getitem__-based iteration would start at
        # absolute index 0 and mis-iterate partially-loaded NAGs
        return iter(self._list)

    def __setitem__(self, i, value):
        self._list[i - self.start_i_level] = value

    def __len__(self):
        return len(self._list)

    @property
    def num_levels(self):
        return len(self._list)

    @property
    def absolute_num_levels(self):
        return self.start_i_level + len(self._list)

    @property
    def end_i_level(self):
        return self.absolute_num_levels - 1

    @property
    def levels(self):
        return list(range(self.start_i_level, self.absolute_num_levels))

    @property
    def num_points(self):
        return [self[i].num_nodes for i in self.levels]

    def clone(self):
        return NAG([d.clone() for d in self._list],
                   start_i_level=self.start_i_level)

    # -- hierarchy maps --------------------------------------------------
    def get_super_index(self, high, low=0):
        """Compose parent maps to get, for each node at `low`, its
        ancestor at level `high`."""
        if not self.start_i_level <= low < high <= self.end_i_level:
            raise ValueError(f'get_super_index: levels {low} -> {high} '
                             f'outside {self.levels}')
        idx = self[low].super_index
        for i in range(low + 1, high):
            idx = self[i].super_index[idx]
        return idx

    def get_sub_size(self, high, low=0):
        """Number of level-`low` nodes inside each level-`high` node."""
        sup = self.get_super_index(high, low=low)
        return np.bincount(sup, minlength=self[high].num_nodes)

    def add_keys_to(self, level, keys, to='x', delete_after=True):
        """Concatenate named attributes into `to`."""
        for i in self._parse_levels(level):
            data = self[i]
            feats = []
            existing = data.get(to)
            if existing is not None:
                feats.append(existing.reshape(existing.shape[0], -1))
            for k in keys:
                v = data.get(k)
                if v is None:
                    raise KeyError(f"Missing key '{k}' at level {i}")
                v = v.reshape(v.shape[0], -1).astype(np.float32)
                if k == 'rgb' and v.max() > 1.5:
                    v = v / 255.0
                feats.append(v)
                if delete_after:
                    del data._store[k]
            if feats:
                data[to] = np.concatenate(feats, axis=1)

    def _parse_levels(self, level):
        if isinstance(level, int):
            return [level]
        if level == 'all':
            return self.levels
        if isinstance(level, str) and level.endswith('+'):
            lo = int(level[:-1])
            return [i for i in self.levels if i >= lo]
        return list(level)

    def select(self, i_level, idx):
        """Select nodes at `i_level` and cascade the selection through
        all levels: children of the selected nodes are kept below,
        parents that keep at least one child are kept above, with all
        indices (super_index, sub, edge_index) renumbered densely."""
        idx = np.asarray(idx)
        if idx.dtype == bool:
            idx = np.where(idx)[0]
        out = [None] * len(self._list)
        start = self.start_i_level

        def o(i):
            return out[i - start]

        def so(i, d):
            out[i - start] = d

        # 1) select at i_level; child_items = kept level-(i_level-1)
        # node ids, ordered grouped by new parent order
        data, child_items = self[i_level].select(idx)
        so(i_level, data)

        # 2) downward: cascade through children
        for i in range(i_level - 1, start - 1, -1):
            keep = child_items
            child, child_items = self[i].select(keep)
            parent = o(i + 1)
            if 'sub' in parent:
                # children are renumbered 0..len(keep)-1 in kept order
                sizes = parent.sub.sizes
                child._store['super_index'] = np.repeat(
                    np.arange(parent.num_nodes, dtype=np.int64), sizes)
                parent._store['sub'] = Cluster(
                    parent.sub.pointers.copy(),
                    np.arange(len(keep), dtype=np.int64))
            so(i, child)
            if child_items is None:
                break

        # 3) upward: keep parents with at least one kept child
        cur_idx = idx
        for i in range(i_level + 1, self.end_i_level + 1):
            if 'super_index' not in self[i - 1]:
                break
            old_sup = self[i - 1].super_index[cur_idx]
            kept_parents = np.unique(old_sup)
            remap = np.full(self[i].num_nodes, -1, dtype=np.int64)
            remap[kept_parents] = np.arange(kept_parents.shape[0])
            o(i - 1)._store['super_index'] = remap[old_sup]
            parent, _ = self[i].select(kept_parents)
            # rebuild parent's sub from the renumbered children
            n_child = o(i - 1).num_nodes
            parent._store['sub'] = Cluster(
                o(i - 1).super_index, np.arange(n_child, dtype=np.int64),
                dense=True)
            so(i, parent)
            cur_idx = kept_parents

        return NAG(out, start_i_level=start)

    # -- I/O --------------------------------------------------------------
    def save(self, path, y_to_csr=True, pos_dtype=np.float32,
             fp_dtype=np.float32, rgb_to_byte=True):
        import h5py
        with h5py.File(path, 'w') as f:
            f.attrs[self._start_key] = self.start_i_level
            for i, data in zip(self.levels, self._list):
                g = f.create_group(f'{self._level_prefix}{i}')
                data.save(g, y_to_csr=y_to_csr, pos_dtype=pos_dtype,
                          fp_dtype=fp_dtype, rgb_to_byte=rgb_to_byte)

    @classmethod
    def load(cls, path, low=0, high=-1, keys=None, keys_low=None,
             non_fp_to_long=False, rgb_to_float=False):
        """Load a NAG (or some of its levels/keys) from HDF5."""
        import h5py
        keys_low = keys if keys_low is None else keys_low
        data_list = []
        with h5py.File(path, 'r') as f:
            start = int(f.attrs.get(cls._start_key, 0))
            levels = sorted(
                int(k[len(cls._level_prefix):]) for k in f.keys()
                if k.startswith(cls._level_prefix))
            max_level = max(levels)
            high = max_level if high < 0 else min(high, max_level)
            low = max(low, start)
            for i in range(low, high + 1):
                g = f[f'{cls._level_prefix}{i}']
                data_list.append(Data.load(
                    g, keys=(keys_low if i == low else keys),
                    non_fp_to_long=non_fp_to_long,
                    rgb_to_float=rgb_to_float))
        return cls(data_list, start_i_level=low)

    def __repr__(self):
        lines = [f'NAG(start_i_level={self.start_i_level})']
        for i, d in zip(self.levels, self._list):
            lines.append(f'  level_{i}: {d}')
        return '\n'.join(lines)
