"""What the kinds of traffic share: the pool of host batches, the card's
name and power limit, the program's kernels built before the window, and
the closed loop that times a window of steps or requests and profiles a
stretch of it."""
import gc
import shutil
import subprocess
import time

import numpy as np

from .trace import profile, step_span
from .traffic import batch_sizes, make_batch

__all__ = ['make_pool', 'card', 'build_kernels', 'closed_loop', 'free',
           'Phases']


def make_pool(cfg, traffic, seed, train):
    """`traffic['pool']` distinct host batches drawn from `seed`, and
    their valid sizes."""
    m = cfg['model']
    seeds = np.random.default_rng(int(seed)).integers(
        0, 2 ** 63, traffic['pool'])
    pool = [make_batch(int(s), traffic['graphs'], traffic['levels'],
                       m['point_hf_dim'], m['edge_hf_dim'],
                       m['num_classes'], traffic['extent'], train=train)
            for s in seeds]
    return pool, [batch_sizes(b) for b in pool]


def card(device):
    """(platform, device name, power limit as nvidia-smi reads it)."""
    import torch
    if device.type != 'cuda':
        return 'cpu', 'cpu', None
    limit = None
    if shutil.which('nvidia-smi'):
        out = subprocess.run(
            ['nvidia-smi', '--query-gpu=power.limit', '--format=csv,noheader',
             f'--id={device.index or 0}'],
            capture_output=True, text=True, timeout=30)
        limit = out.stdout.strip() or None
    return 'gpu', torch.cuda.get_device_name(device), limit


def build_kernels(device):
    """Build (or load from the checkout's build directory) the program's
    CUDA kernels, so that nothing compiles in the window."""
    if device.type == 'cuda':
        from superpoint_transformer_torch.ops import cuda_build
        cuda_build.build()


def _sync(device):
    import torch
    if device.type == 'cuda':
        torch.cuda.synchronize(device)


def closed_loop(call, pool_len, seconds, device, trace_steps=None,
                on_done=None):
    """Call `call(i)` on pool batches i = 0, 1, ... in turn, one after
    the other, until `seconds` have passed since the start; each call's
    host time is recorded. No synchronize between calls; one at the end,
    inside the window. With `trace_steps`, the `trace_steps` calls that
    start after a third of the window run under the profiler, between two
    synchronizes. `on_done(k, out)` receives each call's output.
    Returns (window seconds, [pool index of each call], [(start, end)
    host seconds of each call], the stretch's `Trace` and its pool
    indices, or None and None)."""
    holder, order, times = {}, [], []
    _sync(device)
    t0 = time.perf_counter()
    stretch = None
    k = 0
    while True:
        now = time.perf_counter()
        if now - t0 >= seconds and (not trace_steps or stretch is not None):
            break
        if trace_steps and stretch is None and now - t0 >= seconds / 3:
            # the stretch's trace holds its own work and no other
            _sync(device)
            stretch = []
            with profile(holder):
                for _ in range(trace_steps):
                    i = k % pool_len
                    with step_span():
                        a = time.perf_counter()
                        out = call(i)
                        b = time.perf_counter()
                    if on_done:
                        on_done(k, out)
                    order.append(i)
                    times.append((a - t0, b - t0))
                    stretch.append(i)
                    k += 1
                with step_span('bench.sync'):
                    _sync(device)
            continue
        i = k % pool_len
        a = time.perf_counter()
        out = call(i)
        b = time.perf_counter()
        if on_done:
            on_done(k, out)
        order.append(i)
        times.append((a - t0, b - t0))
        k += 1
    _sync(device)
    window = time.perf_counter() - t0
    return window, order, times, holder.get('trace'), stretch


def free(device):
    import torch
    gc.collect()
    if device.type == 'cuda':
        torch.cuda.empty_cache()


class Phases:
    """The set-up's split: process seconds at the end of each phase."""

    def __init__(self, clock):
        self.clock, self.marks = clock, [('start', clock())]

    def mark(self, name):
        self.marks.append((name, self.clock()))

    def split(self):
        return {name: round(t - t0, 3) for (_, t0), (name, t) in
                zip(self.marks, self.marks[1:])} | {'before': round(
                    self.marks[0][1], 3)}
