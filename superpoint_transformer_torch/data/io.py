"""HDF5 array (de)serialization, the file format of the JAX package's
`data/io.py` (itself the reference's src/utils/io.py). Integer arrays are
stored with the smallest precision-preserving dtype among {uint8, int16,
int32, int64}; floats are cast to `fp_dtype`. h5py is imported only by
the functions that read or write files: the port runs without it.
"""
import numpy as np

__all__ = [
    'cast_to_optimal_integer_dtype', 'save_array', 'load_array',
    'save_dense_to_csr', 'load_csr_to_dense',
]

_INT_CANDIDATES = (np.uint8, np.int16, np.int32, np.int64)


def cast_to_optimal_integer_dtype(a):
    """Smallest precision-preserving integer dtype."""
    a = np.asarray(a)
    if a.size == 0:
        return a.astype(np.uint8)
    lo, hi = int(a.min()), int(a.max())
    for dt in _INT_CANDIDATES:
        info = np.iinfo(dt)
        if info.min <= lo and hi <= info.max:
            return a.astype(dt)
    raise ValueError("Could not cast to integer dtype")


def save_array(x, f, key, fp_dtype=np.float32):
    x = np.asarray(x)
    if x.dtype == bool:
        x = x.astype(np.uint8)
    if np.issubdtype(x.dtype, np.floating):
        d = x.astype(fp_dtype)
    else:
        d = cast_to_optimal_integer_dtype(x)
    f.create_dataset(key, data=d, dtype=d.dtype)


def load_array(f, key=None, idx=None, non_fp_to_long=False):
    import h5py
    ds = f if isinstance(f, h5py.Dataset) else f[key]
    x = ds[:]
    if idx is not None:
        x = x[idx]
    if non_fp_to_long and not np.issubdtype(x.dtype, np.floating):
        x = x.astype(np.int64)
    return x


def save_dense_to_csr(x, f, fp_dtype=np.float32):
    """Compress a 2D array in CSR and save pointers/columns/values/shape."""
    x = np.asarray(x)
    if x.ndim != 2:
        raise ValueError(f'save_dense_to_csr: expected 2-D, got {x.shape}')
    rows, cols = np.nonzero(x)
    values = x[rows, cols]
    pointers = np.zeros(x.shape[0] + 1, dtype=np.int64)
    np.cumsum(np.bincount(rows, minlength=x.shape[0]), out=pointers[1:])
    save_array(pointers, f, 'pointers', fp_dtype=fp_dtype)
    save_array(cols, f, 'columns', fp_dtype=fp_dtype)
    save_array(values, f, 'values', fp_dtype=fp_dtype)
    f.create_dataset('shape', data=np.array(x.shape))


def load_csr_to_dense(f, idx=None, non_fp_to_long=False):
    pointers = f['pointers'][:].astype(np.int64)
    columns = f['columns'][:].astype(np.int64)
    values = f['values'][:]
    shape = tuple(int(s) for s in f['shape'][:])
    if non_fp_to_long and not np.issubdtype(values.dtype, np.floating):
        values = values.astype(np.int64)
    n = shape[0]
    out = np.zeros(shape, dtype=values.dtype)
    row = np.repeat(np.arange(n), np.diff(pointers))
    out[row, columns] = values
    if idx is not None:
        out = out[idx]
    return out
