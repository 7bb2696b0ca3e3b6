"""Host-side `Data` container: one partition level of a point cloud or
superpoint hierarchy, a copy of the JAX package's `data/data.py`.

A flexible key -> numpy array store with SPT's conventions:
  - pos [N, 3], x [N, D] features
  - super_index [N]    parent id in the level above
  - sub (Cluster)      children in the level below
  - edge_index [2, E], edge_attr [E, De]   horizontal graph
  - v_edge_attr [N, Dv]  vertical (child->parent) edge features
  - y                  labels: [N] int or [N, C+1] histogram
  - neighbor_index / neighbor_distance [N, K]
  - obj (InstanceData) instance overlaps
HDF5 save/load reads and writes the JAX package's files (CSR-packed y,
byte rgb, smallest-int compression, `_not_indexable_` bookkeeping);
h5py is imported only there.
"""
import numpy as np

from ..debug import is_debug_enabled, validate_data
from .csr import CSRData, Cluster, InstanceData
from .io import (
    save_array, load_array, save_dense_to_csr, load_csr_to_dense)

__all__ = ['Data']

# Keys that never index along nodes
_NOT_INDEXABLE_DEFAULT = ('edge_index', 'edge_attr', 'pos_offset',
                          'obj_edge_index', 'obj_edge_affinity')


class Data:
    def __init__(self, **kwargs):
        self._store = {}
        for k, v in kwargs.items():
            if v is not None:
                self[k] = v
        if is_debug_enabled():
            validate_data(self)

    # -- dict-like interface ------------------------------------------
    def __getattr__(self, key):
        store = object.__getattribute__(self, '_store')
        if key in store:
            return store[key]
        raise AttributeError(key)

    def get(self, key, default=None):
        return self._store.get(key, default)

    def __setattr__(self, key, value):
        if key == '_store':
            object.__setattr__(self, key, value)
        elif value is None:
            self._store.pop(key, None)
        else:
            self._store[key] = value

    def __getitem__(self, key):
        return self._store[key]

    def __setitem__(self, key, value):
        if isinstance(value, (np.ndarray, CSRData)):
            self._store[key] = value
        else:
            self._store[key] = np.asarray(value)

    def __contains__(self, key):
        return key in self._store

    def __delitem__(self, key):
        del self._store[key]

    def keys(self):
        return list(self._store.keys())

    def items(self):
        return self._store.items()

    def to_dict(self):
        return dict(self._store)

    def clone(self):
        out = Data()
        for k, v in self._store.items():
            out._store[k] = v.copy() if isinstance(v, np.ndarray) else v
        return out

    # -- shape info ----------------------------------------------------
    @property
    def num_nodes(self):
        for k in ('pos', 'x', 'super_index', 'rgb'):
            if k in self._store:
                return int(self._store[k].shape[0])
        if 'sub' in self._store:
            return self._store['sub'].num_groups
        return 0

    @property
    def num_edges(self):
        ei = self._store.get('edge_index')
        return 0 if ei is None else int(ei.shape[1])

    @property
    def num_points(self):
        """Total number of level-0 points covered (via sub sizes)."""
        sub = self._store.get('sub')
        return self.num_nodes if sub is None else sub.num_items

    def node_attrs(self):
        """Keys indexed along the node dimension."""
        n = self.num_nodes
        out = []
        for k, v in self._store.items():
            if k in _NOT_INDEXABLE_DEFAULT:
                continue
            if isinstance(v, CSRData):
                if v.num_groups == n:
                    out.append(k)
            elif v.ndim >= 1 and v.shape[0] == n:
                out.append(k)
        return out

    # -- selection ------------------------------------------------------
    def select(self, idx):
        """Select nodes by index, remapping edges and CSR children.
        Returns (new Data, sub item ids or None)."""
        idx = np.asarray(idx)
        if idx.dtype == bool:
            idx = np.where(idx)[0]
        n = self.num_nodes
        remap = np.full(n, -1, dtype=np.int64)
        remap[idx] = np.arange(idx.shape[0])

        out = Data()
        sub_item_idx = None
        for k, v in self._store.items():
            if k in ('edge_index', 'edge_attr'):
                continue
            if isinstance(v, CSRData):
                new_v, _ = v[idx]
                out._store[k] = new_v
                if k == 'sub':
                    # the selected cluster's values hold the (old) child
                    # node ids, grouped by new parent order
                    sub_item_idx = new_v.points
            elif k in _NOT_INDEXABLE_DEFAULT:
                out._store[k] = v
            elif v.ndim >= 1 and v.shape[0] == n:
                out._store[k] = v[idx]
            else:
                out._store[k] = v

        # Remap horizontal edges, dropping those touching removed nodes
        ei = self._store.get('edge_index')
        if ei is not None:
            s, t = remap[ei[0]], remap[ei[1]]
            keep = (s >= 0) & (t >= 0)
            out._store['edge_index'] = np.stack([s[keep], t[keep]])
            ea = self._store.get('edge_attr')
            if ea is not None:
                out._store['edge_attr'] = ea[keep]
        return out, sub_item_idx

    # -- I/O -------------------------------------------------------------
    def save(self, f, y_to_csr=True, pos_dtype=np.float32,
             fp_dtype=np.float32, rgb_to_byte=True):
        import h5py
        if not isinstance(f, (h5py.File, h5py.Group)):
            with h5py.File(f, 'w') as file:
                self.save(file, y_to_csr=y_to_csr, pos_dtype=pos_dtype,
                          fp_dtype=fp_dtype, rgb_to_byte=rgb_to_byte)
            return
        for k, v in self._store.items():
            if k == 'pos_offset':
                save_array(v, f, k, fp_dtype=np.float64)
            elif k == 'pos':
                save_array(v, f, k, fp_dtype=pos_dtype)
            elif k == 'y' and v.ndim > 1 and y_to_csr:
                sg = f.create_group(f"{f.name}/_csr_/{k}")
                save_dense_to_csr(v, sg, fp_dtype=fp_dtype)
            elif k in ('rgb', 'mean_rgb') and rgb_to_byte:
                if np.issubdtype(v.dtype, np.floating):
                    save_array((v * 255).astype(np.uint8), f, k)
                else:
                    save_array(v.astype(np.uint8), f, k)
            elif isinstance(v, Cluster):
                sg = f.create_group(f"{f.name}/_cluster_/{k}")
                v.save(sg, fp_dtype=fp_dtype)
            elif isinstance(v, InstanceData):
                sg = f.create_group(f"{f.name}/_instance_data_/{k}")
                v.save(sg, fp_dtype=fp_dtype)
            elif isinstance(v, CSRData):
                sg = f.create_group(f"{f.name}/_csr_/{k}")
                v.save(sg, fp_dtype=fp_dtype)
            else:
                save_array(v, f, k, fp_dtype=fp_dtype)
        not_idx = list(set(self.keys()) - set(self.node_attrs()))
        f['_not_indexable_'] = not_idx

    @classmethod
    def load(cls, f, idx=None, keys=None, non_fp_to_long=False,
             rgb_to_float=False):
        import h5py
        if not isinstance(f, (h5py.File, h5py.Group)):
            with h5py.File(f, 'r') as file:
                return cls.load(file, idx=idx, keys=keys,
                                non_fp_to_long=non_fp_to_long,
                                rgb_to_float=rgb_to_float)
        not_indexable = set(_NOT_INDEXABLE_DEFAULT)
        if '_not_indexable_' in f:
            raw = f['_not_indexable_'][:]
            not_indexable |= {s.decode() if isinstance(s, bytes) else str(s)
                              for s in raw}
        out = cls()
        groups = {'_csr_': None, '_cluster_': Cluster,
                  '_instance_data_': InstanceData}
        for k in f.keys():
            if k == '_not_indexable_':
                continue
            if k in groups:
                for sub_k in f[k].keys():
                    if keys is not None and sub_k not in keys:
                        continue
                    g = f[k][sub_k]
                    sel = idx if (idx is not None
                                  and sub_k not in not_indexable) else None
                    if k == '_csr_':
                        out._store[sub_k] = load_csr_to_dense(
                            g, idx=sel, non_fp_to_long=non_fp_to_long)
                    else:
                        v = groups[k].load(g, non_fp_to_long=non_fp_to_long)
                        if sel is not None:
                            v, _ = v[sel]
                        out._store[sub_k] = v
                continue
            if keys is not None and k not in keys:
                continue
            sel = idx if (idx is not None and k not in not_indexable) \
                else None
            v = load_array(f, k, idx=sel, non_fp_to_long=non_fp_to_long)
            if rgb_to_float and k in ('rgb', 'mean_rgb') and \
                    not np.issubdtype(v.dtype, np.floating):
                v = v.astype(np.float32) / 255.0
            out._store[k] = v
        return out

    def __repr__(self):
        fields = ', '.join(
            f'{k}={_shape_str(v)}' for k, v in self._store.items())
        return f'Data({fields})'


def _shape_str(v):
    if isinstance(v, np.ndarray):
        return f'[{", ".join(map(str, v.shape))}]'
    return repr(v)
