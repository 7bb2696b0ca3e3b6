"""Tracing and timing helpers: counterpart of
`superpoint_transformer_tpu/utils/profiling.py` (reference: Lightning
profilers via configs/debug/profiler.yaml and per-transform wall times,
Transform.__call__(verbose=True), utils/time.py:8).

`trace` records a `torch.profiler` trace (host and, where there is a
card, CUDA activity) and writes it as a Chrome trace; `annotate` names a
span in it. `timer` and `Timings` are host wall-clock timers.
"""
import contextlib
import os
import time
from collections import defaultdict

__all__ = ['timer', 'Timings', 'trace', 'annotate']


@contextlib.contextmanager
def timer(name='', out=None, verbose=True):
    """Wall-clock a block; adds the seconds to `out[name]` if given."""
    t0 = time.perf_counter()
    yield
    dt = time.perf_counter() - t0
    if out is not None:
        out[name] = out.get(name, 0.0) + dt
    if verbose:
        print(f'[timer] {name}: {dt:.3f}s')


class Timings:
    """Accumulating named wall-clock timers (seconds per stage; the
    preprocessing pipeline's per-transform times, reference
    BaseDataset.process(verbose))."""

    def __init__(self):
        self.totals = defaultdict(float)
        self.counts = defaultdict(int)

    @contextlib.contextmanager
    def track(self, name):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            self.totals[name] += time.perf_counter() - t0
            self.counts[name] += 1

    def summary(self):
        rows = sorted(self.totals.items(), key=lambda kv: -kv[1])
        return '\n'.join(
            f'{k:<40s} {v:8.3f}s  (x{self.counts[k]})'
            for k, v in rows)


@contextlib.contextmanager
def trace(log_dir):
    """`torch.profiler` trace of the block, CPU activity and, when CUDA
    is available, CUDA activity; written to `log_dir/trace.json` (Chrome
    trace format: chrome://tracing or Perfetto). Yields the profiler, so
    the caller may also read `key_averages()`."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with profile(activities=activities) as prof:
        yield prof
    prof.export_chrome_trace(os.path.join(log_dir, 'trace.json'))


def annotate(name):
    """A named span in a `trace` (`torch.profiler.record_function`)."""
    import torch
    return torch.profiler.record_function(name)
