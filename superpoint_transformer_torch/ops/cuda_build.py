"""Build the port's CUDA kernels with nvcc and load them through ctypes.

Each `csrc/<name>.cu` has a plain C entry point and compiles on its own
into `_build/lib<name>.so` (git-ignored) for sm_90a, at first use or when
its source is newer than the library. Nothing here runs at import time:
the CPU tests import every module on a machine without nvcc.
"""
import ctypes
import functools
import os
import shutil
import subprocess
from pathlib import Path

__all__ = ['KERNELS', 'NVCC_FLAGS', 'build', 'library']

_PKG = Path(__file__).resolve().parents[1]
_CSRC = _PKG / 'csrc'
_BUILD_DIR = _PKG / '_build'
KERNELS = ('dense_attention', 'dense_attention_rpe', 'dense_attention_rpe_bwd')
NVCC_FLAGS = ('-gencode', 'arch=compute_90a,code=sm_90a', '-std=c++17',
              '-O3', '-shared', '-Xcompiler', '-fPIC', '-Xptxas', '-v')


def _nvcc():
    home = os.environ.get('CUDA_HOME') or os.environ.get('CUDA_PATH') \
        or '/usr/local/cuda'
    path = Path(home) / 'bin' / 'nvcc'
    if path.exists():
        return str(path)
    found = shutil.which('nvcc')
    if found is None:
        raise RuntimeError('nvcc not found: set CUDA_HOME to a CUDA toolkit '
                           'to build the kernels in csrc/')
    return found


def _paths(name):
    return _CSRC / f'{name}.cu', _BUILD_DIR / f'lib{name}.so'


def build(names=KERNELS, force=False):
    """Compile the named sources, one nvcc process each, all started
    together; a library is rebuilt when `force` is set or it is missing or
    older than its source. Waits for every process, then raises if any
    failed. Returns {name: compiler report (registers, shared memory and
    spills per kernel)} for the libraries it compiled."""
    _BUILD_DIR.mkdir(exist_ok=True)
    jobs = {}
    for name in names:
        src, lib = _paths(name)
        if not force and lib.exists() \
                and lib.stat().st_mtime >= src.stat().st_mtime:
            continue
        tmp = lib.with_name(f'{lib.name}.{os.getpid()}.tmp')
        proc = subprocess.Popen([_nvcc(), *NVCC_FLAGS, '-o', str(tmp),
                                 str(src)], stdout=subprocess.PIPE,
                                stderr=subprocess.PIPE, text=True)
        jobs[name] = (proc, tmp, lib, src)
    reports, failed = {}, []
    for name, (proc, tmp, lib, src) in jobs.items():
        _, err = proc.communicate()
        if proc.returncode != 0:
            failed.append(f'nvcc failed on {src}:\n{err}')
            continue
        os.replace(tmp, lib)
        reports[name] = err
    if failed:
        raise RuntimeError('\n'.join(failed))
    return reports


@functools.lru_cache(maxsize=None)
def library(name):
    """The loaded library of `csrc/<name>.cu`, built first if needed."""
    build((name,))
    return ctypes.CDLL(str(_paths(name)[1]))
