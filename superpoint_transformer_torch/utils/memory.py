"""Memory and failure helpers: counterpart of
`superpoint_transformer_tpu/utils/memory.py` (reference
src/utils/memory.py:19-53 OOM classification and garbage collection,
utils/utils.py:30 task_wrapper), for PyTorch and CUDA."""
import functools
import gc
import os
import traceback

__all__ = ['is_oom_error', 'garbage_collection', 'task_wrapper',
           'device_memory_stats', 'tune_host_allocator']

_OOM_MARKERS = (
    'out of memory',                 # CUDA: "CUDA out of memory", "CUDA
                                     # error: out of memory"
    'Out of memory',
    'Failed to allocate',
    'DefaultCPUAllocator: can\'t allocate memory',
)


def is_oom_error(exception):
    """True if the exception is a device or host out-of-memory error."""
    import torch
    if isinstance(exception, (MemoryError, torch.cuda.OutOfMemoryError)):
        return True
    msg = str(exception)
    return any(m in msg for m in _OOM_MARKERS)


def garbage_collection():
    """Drop Python garbage and, where CUDA is up, release the caching
    allocator's free blocks (`torch.cuda.empty_cache`)."""
    import torch
    gc.collect()
    if torch.cuda.is_available() and torch.cuda.is_initialized():
        torch.cuda.empty_cache()


def device_memory_stats():
    """{'cuda:<i>': torch.cuda.memory_stats(i)} for every CUDA device;
    empty without CUDA."""
    import torch
    if not torch.cuda.is_available():
        return {}
    return {f'cuda:{i}': torch.cuda.memory_stats(i)
            for i in range(torch.cuda.device_count())}


def task_wrapper(fn):
    """Run `fn`; on an exception print its traceback, flag an OOM (and
    collect garbage), then re-raise (reference task_wrapper,
    src/utils/utils.py:30)."""

    @functools.wraps(fn)
    def wrapped(*args, **kwargs):
        try:
            return fn(*args, **kwargs)
        except Exception as e:
            traceback.print_exc()
            if is_oom_error(e):
                print('[task_wrapper] out of memory: consider lowering '
                      'max_num_nodes / batch_size')
                garbage_collection()
            raise
    return wrapped


_MALLOC_TUNED = False


def tune_host_allocator():
    """Keep freed large allocations in the process heap instead of
    returning them to the OS (glibc mallopt: mmap threshold 1 GiB, no
    trim, no mmap).

    The host preprocessing and batch path allocates and frees many
    multi-MB numpy temporaries per cloud; with glibc's default every one
    of them is a fresh mmap whose pages fault in on first touch and go
    back on free. Reusing heap pages makes an allocation cost O(size)
    instead of O(page faults). `chip_smoke.py` times `e2e_inference`'s
    preprocessing with and without it on the card machine's host.

    Idempotent; returns True when it tuned the allocator, False on a
    platform without glibc or when SPT_NO_MALLOC_TUNING is set. The cost:
    the process keeps its high-water-mark memory."""
    global _MALLOC_TUNED
    if _MALLOC_TUNED or os.environ.get('SPT_NO_MALLOC_TUNING'):
        return False
    import ctypes
    try:
        libc = ctypes.CDLL('libc.so.6', use_errno=True)
    except OSError:
        return False
    libc.mallopt.argtypes = (ctypes.c_int, ctypes.c_int)
    libc.mallopt.restype = ctypes.c_int
    # glibc malloc.h: M_TRIM_THRESHOLD=-1, M_MMAP_THRESHOLD=-3,
    # M_MMAP_MAX=-4
    libc.mallopt(-3, 1 << 30)
    libc.mallopt(-1, -1)
    libc.mallopt(-4, 0)
    _MALLOC_TUNED = True
    return True
