"""ctypes binding to the repository's C++ host kernels (`native/*.cpp`):

  - spt_greedy_cut: greedy L0/Potts graph-partition solver
  - spt_radius_knn: fixed-radius KNN on a voxel hash grid
  - spt_eigen_features: per-point neighborhood PCA
  - spt_anchor_nn / spt_subedges: superedge anchors and subedge pairs

At first use the sources are compiled with the compiler and flags of
`native/Makefile` (`CXX` from the environment overrides its compiler, as
with make) into `_build/libspt_native.so` beside the package
(git-ignored), and rebuilt when a source or the Makefile is newer; the
command that built it is written beside it (`libspt_native.so.cmd`).
Where the compiler has no OpenMP runtime, the library is built without
`-fopenmp`, with a warning: every OpenMP use in the sources is guarded by
`_OPENMP`, so it computes the same results on one thread. The prebuilt
`native/libspt_native.so` is never loaded: it may have been built for
another machine. If the library cannot be built or loaded, these
functions raise; there is no pure-Python fallback. Nothing here runs at
import time.
"""
import ctypes
import fcntl
import functools
import os
import re
import shlex
import subprocess
import warnings
from pathlib import Path

import numpy as np

__all__ = ['build', 'library', 'native_available', 'greedy_cut',
           'radius_knn', 'eigen_features', 'anchor_nn', 'subedges_pairs']

_NATIVE_DIR = Path(__file__).resolve().parents[2] / 'native'
_BUILD_DIR = Path(__file__).resolve().parents[1] / '_build'
_LIB_NAME = 'libspt_native.so'


def _make_vars(makefile):
    """The `NAME ?= value` / `NAME := value` assignments of a Makefile."""
    out = {}
    for line in makefile.read_text().splitlines():
        m = re.match(r'^([A-Z]+)\s*[?:]?=\s*(.*)$', line)
        if m:
            out[m.group(1)] = m.group(2).strip()
    return out


def build(build_dir=None, force=False):
    """Compile `native/*.cpp` as `native/Makefile` says into
    `build_dir/libspt_native.so` (default `_build/`), unless it exists
    and is newer than the sources and the Makefile, or `force`. One
    process builds at a time (a file lock), the others wait and reuse
    its library. Returns the library's path; raises RuntimeError with
    the compiler's message if the build fails."""
    build_dir = Path(build_dir) if build_dir is not None else _BUILD_DIR
    makefile = _NATIVE_DIR / 'Makefile'
    make = _make_vars(makefile)
    sources = [_NATIVE_DIR / s for s in make['SRCS'].split()]
    lib = build_dir / _LIB_NAME
    build_dir.mkdir(parents=True, exist_ok=True)
    with open(build_dir / f'{_LIB_NAME}.lock', 'w') as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        if not force and _up_to_date(lib, sources, makefile):
            return lib
        cxx = os.environ.get('CXX') or make['CXX']
        flags = shlex.split(make['CXXFLAGS'])
        tmp = lib.with_name(f'{lib.name}.{os.getpid()}.tmp')
        cmd, err = _compile(cxx, flags, tmp, sources)
        if err is not None and '-fopenmp' in flags and _NO_OPENMP.search(err):
            warnings.warn(f'{cxx} has no OpenMP runtime: building {lib} '
                          f'without -fopenmp (one thread)\n{err}')
            cmd, err = _compile(
                cxx, [f for f in flags if f != '-fopenmp'], tmp, sources)
        if err is not None:
            raise RuntimeError(f'cannot build {lib}: {shlex.join(cmd)} '
                               f'failed:\n{err}')
        os.replace(tmp, lib)
        lib.with_name(f'{lib.name}.cmd').write_text(
            shlex.join(cmd).replace(str(tmp), str(lib)) + '\n')
    return lib


def _up_to_date(lib, sources, makefile):
    """Whether `lib` exists and is newer than the sources and the
    Makefile."""
    newest = max(p.stat().st_mtime for p in sources + [makefile])
    return lib.exists() and lib.stat().st_mtime >= newest


def native_available():
    """Whether the host library is built in `_build/`, up to date with
    `native/*.cpp` and the Makefile, and loads. It builds nothing: `build`
    does, as the first call of a host function does. A library that is
    up to date but does not load raises, as the host functions would."""
    makefile = _NATIVE_DIR / 'Makefile'
    sources = [_NATIVE_DIR / s
               for s in _make_vars(makefile)['SRCS'].split()]
    if not _up_to_date(_BUILD_DIR / _LIB_NAME, sources, makefile):
        return False
    library()
    return True


# what a compiler without an OpenMP runtime says to -fopenmp
_NO_OPENMP = re.compile(r'libgomp|fopenmp|omp\.h', re.IGNORECASE)


def _compile(cxx, flags, out, sources):
    """Run one compile-and-link; returns (command, None) or (command,
    the compiler's error output)."""
    cmd = [cxx, *flags, '-shared', '-o', str(out), *map(str, sources)]
    try:
        proc = subprocess.run(cmd, capture_output=True, text=True)
    except OSError as e:
        return cmd, f'the C++ compiler (CXX) does not run: {e}'
    return cmd, (proc.stderr if proc.returncode != 0 else None)


_i32p = ctypes.POINTER(ctypes.c_int32)
_i64p = ctypes.POINTER(ctypes.c_int64)
_f32p = ctypes.POINTER(ctypes.c_float)
_f64p = ctypes.POINTER(ctypes.c_double)
_i64, _i32, _f64 = ctypes.c_int64, ctypes.c_int32, ctypes.c_double
_SIGNATURES = {
    'spt_greedy_cut': (_i64, [_i64, _i64, _f32p, _f32p, _i64, _i32p,
                              _i32p, _f32p, _f64, _f64, _i32, _i32p]),
    'spt_radius_knn': (None, [_i64, _f32p, _i64, _f32p, _f64, _i64, _i64,
                              _i32p, _f32p]),
    'spt_eigen_features': (None, [_i64, _f32p, _i64, _i32p, _i64, _f32p,
                                  _f32p, _i32p]),
    'spt_anchor_nn': (None, [_i64, _f64p, _i64, _i64p, _i64p, _i64,
                             _i64p, _i64p, _i64, _i64p, _i64p]),
    'spt_subedges': (None, [_i64, _f64p, _i64, _i64p, _i64p, _i64, _i64p,
                            _i64p, _f64, _i64, _i64, _f64, _i32, _i32,
                            _i32, _i32, _i64p, _i64p, _i64p, _i64p]),
}


@functools.lru_cache(maxsize=None)
def library():
    """The loaded library, built first if needed, with every entry
    point's argument and result types declared."""
    lib = ctypes.CDLL(str(build()))
    for name, (restype, argtypes) in _SIGNATURES.items():
        fn = getattr(lib, name)
        fn.restype = restype
        fn.argtypes = argtypes
    return lib


def _ptr(a, ctype):
    return a.ctypes.data_as(ctypes.POINTER(ctype))


def greedy_cut(features, edge_index, edge_weight=None, node_weight=None,
               reg=0.1, cutoff=10, refine_sweeps=8):
    """Greedy L0 partition. `features` [N, D] float32 (pre-scaled),
    trimmed `edge_index` [2, E]. Returns (super_index [N] int64,
    n_components).

    `refine_sweeps` > 0 adds boundary-reassignment sweeps (exact energy
    descent) and a connectivity split after the greedy merge; 0 gives
    the merge-only solver."""
    f = np.ascontiguousarray(features, dtype=np.float32)
    n, d = f.shape
    src = np.ascontiguousarray(edge_index[0], dtype=np.int32)
    dst = np.ascontiguousarray(edge_index[1], dtype=np.int32)
    ew = None if edge_weight is None else np.ascontiguousarray(
        edge_weight.reshape(-1), dtype=np.float32)
    nw = None if node_weight is None else np.ascontiguousarray(
        node_weight.reshape(-1), dtype=np.float32)
    out = np.empty(n, dtype=np.int32)
    n_comp = library().spt_greedy_cut(
        n, d, _ptr(f, ctypes.c_float),
        _ptr(nw, ctypes.c_float) if nw is not None else None,
        src.shape[0], _ptr(src, ctypes.c_int32), _ptr(dst, ctypes.c_int32),
        _ptr(ew, ctypes.c_float) if ew is not None else None,
        float(reg), float(cutoff), int(refine_sweeps),
        _ptr(out, ctypes.c_int32))
    return out.astype(np.int64), int(n_comp)


def radius_knn(xyz_search, xyz_query=None, r=1.0, k=10,
               exclude_self=None):
    """Fixed-radius KNN; returns (nbr_idx [Nq, k] int32 with -1
    padding, dist [Nq, k] float32 with +inf padding)."""
    xs = np.ascontiguousarray(xyz_search, dtype=np.float32)
    self_search = xyz_query is None
    xq = xs if self_search else np.ascontiguousarray(
        xyz_query, dtype=np.float32)
    if exclude_self is None:
        exclude_self = self_search
    nq = xq.shape[0]
    nbr = np.empty((nq, k), dtype=np.int32)
    dist = np.empty((nq, k), dtype=np.float32)
    library().spt_radius_knn(
        xs.shape[0], _ptr(xs, ctypes.c_float), nq, _ptr(xq, ctypes.c_float),
        float(r), int(k), int(bool(exclude_self)),
        _ptr(nbr, ctypes.c_int32), _ptr(dist, ctypes.c_float))
    return nbr, dist


def _edge_csr_args(points, order, ptr, edge_index):
    pts = np.ascontiguousarray(points, dtype=np.float64)
    order = np.ascontiguousarray(order, dtype=np.int64)
    ptr = np.ascontiguousarray(ptr, dtype=np.int64)
    src = np.ascontiguousarray(edge_index[0], dtype=np.int64)
    dst = np.ascontiguousarray(edge_index[1], dtype=np.int64)
    return pts, order, ptr, src, dst


def anchor_nn(points, order, ptr, edge_index, cycles=3):
    """Per-edge anchor (approximate closest point pair) search
    (native/subedges.cpp). `points` [N, 3] float64, CSR (`order`, `ptr`)
    over segments, trimmed `edge_index` [2, E]. Returns [2, E] int64
    point ids."""
    pts, order, ptr, src, dst = _edge_csr_args(points, order, ptr,
                                               edge_index)
    e = src.shape[0]
    out_s = np.empty(e, dtype=np.int64)
    out_t = np.empty(e, dtype=np.int64)
    library().spt_anchor_nn(
        pts.shape[0], _ptr(pts, ctypes.c_double),
        ptr.shape[0] - 1, _ptr(order, ctypes.c_int64),
        _ptr(ptr, ctypes.c_int64), e, _ptr(src, ctypes.c_int64),
        _ptr(dst, ctypes.c_int64), int(cycles),
        _ptr(out_s, ctypes.c_int64), _ptr(out_t, ctypes.c_int64))
    return np.stack([out_s, out_t])


def subedges_pairs(points, order, ptr, edge_index, ratio=0.2,
                   k_min=20, cycles=3, margin=0.2,
                   halfspace_filter=True, bbox_filter=True,
                   target_pc_flip=True, source_pc_sort=False):
    """Per-edge subedge pipeline (native/subedges.cpp). Returns
    (pairs [2, M] int64 point ids, uid [M] int64 edge ids)."""
    pts, order, ptr, src, dst = _edge_csr_args(points, order, ptr,
                                               edge_index)
    e = src.shape[0]
    sizes = ptr[1:] - ptr[:-1]
    ub = np.minimum(sizes[src], sizes[dst])
    out_ptr = np.zeros(e + 1, dtype=np.int64)
    np.cumsum(ub, out=out_ptr[1:])
    cap = int(out_ptr[-1])
    out_s = np.empty(cap, dtype=np.int64)
    out_t = np.empty(cap, dtype=np.int64)
    out_k = np.empty(e, dtype=np.int64)
    library().spt_subedges(
        pts.shape[0], _ptr(pts, ctypes.c_double),
        ptr.shape[0] - 1, _ptr(order, ctypes.c_int64),
        _ptr(ptr, ctypes.c_int64), e, _ptr(src, ctypes.c_int64),
        _ptr(dst, ctypes.c_int64), float(ratio), int(k_min),
        int(cycles), float(margin), int(bool(halfspace_filter)),
        int(bool(bbox_filter)), int(bool(target_pc_flip)),
        int(bool(source_pc_sort)), _ptr(out_ptr, ctypes.c_int64),
        _ptr(out_s, ctypes.c_int64), _ptr(out_t, ctypes.c_int64),
        _ptr(out_k, ctypes.c_int64))
    # compact the ub-strided per-edge blocks into dense [M] arrays
    uid = np.repeat(np.arange(e, dtype=np.int64), out_k)
    new_ptr = np.zeros(e + 1, dtype=np.int64)
    np.cumsum(out_k, out=new_ptr[1:])
    rel = np.arange(new_ptr[-1], dtype=np.int64) - new_ptr[uid]
    pos = out_ptr[uid] + rel
    return np.stack([out_s[pos], out_t[pos]]), uid


def eigen_features(xyz, nbr_idx, add_self=True):
    """Per-point neighborhood PCA. `nbr_idx` [N, K] with -1 at invalid
    slots. Returns (w [N,3] float32 ascending, V [N,3,3] float32 with
    V[:, :, j] the eigenvector of w_j, counts [N] int32)."""
    xyz = np.ascontiguousarray(xyz, dtype=np.float32)
    nbr = np.ascontiguousarray(nbr_idx, dtype=np.int32)
    n, k = nbr.shape
    w = np.empty((n, 3), dtype=np.float32)
    v = np.empty((n, 3, 3), dtype=np.float32)
    cnt = np.empty(n, dtype=np.int32)
    library().spt_eigen_features(
        n, _ptr(xyz, ctypes.c_float), k, _ptr(nbr, ctypes.c_int32),
        int(bool(add_self)), _ptr(w, ctypes.c_float),
        _ptr(v, ctypes.c_float), _ptr(cnt, ctypes.c_int32))
    return w, v, cnt
