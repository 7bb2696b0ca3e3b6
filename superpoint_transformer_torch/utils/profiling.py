"""Tracing and timing helpers: counterpart of
`superpoint_transformer_tpu/utils/profiling.py` (reference: Lightning
profilers via configs/debug/profiler.yaml and per-transform wall times,
Transform.__call__(verbose=True), utils/time.py:8).

`trace` records a `torch.profiler` trace (host and, where there is a
card, CUDA activity) and writes it as a Chrome trace; `annotate` names a
span in it, and costs next to nothing while no profiler runs. `Timings`
accumulates host wall-clock timers.
"""
import contextlib
import os
import time
from collections import defaultdict

import torch

__all__ = ['Timings', 'trace', 'annotate']


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
    from torch.profiler import ProfilerActivity, profile
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with profile(activities=activities) as prof:
        yield prof
    prof.export_chrome_trace(os.path.join(log_dir, 'trace.json'))


# the one context `annotate` returns while no profiler runs, and the
# profiler's own flag (set by every profiler, NVTX's included)
_OFF = contextlib.nullcontext()
_profiler_on = torch._C._autograd._profiler_enabled


def annotate(name):
    """A named span in a profiler's trace: `torch.profiler.record_function`
    while a profiler runs on this thread (`trace`, `torch.profiler.profile`,
    `emit_nvtx`; the autograd engine's threads inherit it), so the span
    shares the clock of the trace's device activity. Otherwise one shared
    null context, with no dispatcher call (record_function costs ~15 us
    even with no profiler)."""
    if _profiler_on():
        return torch.profiler.record_function(name)
    return _OFF
