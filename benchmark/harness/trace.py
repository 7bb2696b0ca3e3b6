"""Profile a stretch of a run with `torch.profiler` and reduce its trace
to what the per-layer metrics read: device intervals (kernels and
copies), their union, the host's spans, and the idle gaps of the device
labelled by what the host was doing.

Each step or request of the stretch runs inside a `bench.step` span
(`record_function`), and the stretch ends with a device synchronize
inside a `bench.sync` span, so the traced window runs from the first
step's start to the end of that synchronize.
"""
import bisect
import json
import os
import re
import tempfile
from contextlib import contextmanager

__all__ = ['Trace', 'profile', 'step_span']

DEVICE_CATS = ('kernel', 'gpu_memcpy', 'gpu_memset')
HOST_CATS = ('cpu_op', 'user_annotation', 'cuda_runtime', 'cuda_driver')
TOP = 10


class Trace:
    """The events of one profiled stretch (times in seconds)."""

    def __init__(self, events):
        dev, host, steps, sync, launch = [], [], [], [], {}
        for e in events:
            if e.get('ph') != 'X' or 'dur' not in e:
                continue
            cat, name = e.get('cat', ''), e.get('name', '')
            t0, dt = float(e['ts']) * 1e-6, float(e['dur']) * 1e-6
            corr = (e.get('args') or {}).get('correlation')
            if cat in DEVICE_CATS:
                dev.append((t0, t0 + dt, cat, name, corr))
            elif cat in HOST_CATS:
                if name == 'bench.step' and cat == 'user_annotation':
                    steps.append((t0, t0 + dt))
                elif name == 'bench.sync' and cat == 'user_annotation':
                    sync.append((t0, t0 + dt))
                else:
                    host.append((t0, t0 + dt, name))
                if cat in ('cuda_runtime', 'cuda_driver') and corr:
                    launch[corr] = t0
        if not steps or not sync:
            raise RuntimeError('trace: the stretch has no bench.step or '
                               'bench.sync span')
        self.step_spans = sorted(steps)
        self.start = self.step_spans[0][0]
        self.end = max(e for _, e in sync)
        self.steps = len(steps)
        self.device = sorted(d[:4] for d in dev
                             if d[1] > self.start and d[0] < self.end)
        # the host time at which each device event was launched
        self._launched = sorted(
            (launch[d[4]], d[1] - d[0], d[2], d[3]) for d in dev
            if d[1] > self.start and d[0] < self.end and d[4] in launch)
        self.host = sorted(host)

    @property
    def window_s(self):
        return self.end - self.start

    def per_step(self, cat, pattern=None):
        """The durations of the device events of category `cat` whose
        name matches `pattern`, a list for each step of the stretch in
        order, each event under the step whose span its launch (the
        runtime call of the same correlation id) started in. An event
        whose launch the trace lacks is under no step."""
        rx = re.compile(pattern) if pattern else None
        starts = [s for s, _ in self.step_spans]
        out = [[] for _ in self.step_spans]
        for t, dur, c, n in self._launched:
            if c != cat or (rx is not None and not rx.search(n)):
                continue
            k = bisect.bisect_right(starts, t) - 1
            if k >= 0 and t <= self.step_spans[k][1]:
                out[k].append(dur)
        return out

    def busy_intervals(self):
        """The union of the device intervals, clipped to the window."""
        out = []
        for s, e, _, _ in self.device:
            s, e = max(s, self.start), min(e, self.end)
            if out and s <= out[-1][1]:
                out[-1][1] = max(out[-1][1], e)
            else:
                out.append([s, e])
        return out

    @property
    def busy_s(self):
        return sum(e - s for s, e in self.busy_intervals())

    def device_seconds(self, cat=None, pattern=None):
        """Summed duration of the device events of category `cat` whose
        name matches the regular expression `pattern` (all where None)."""
        rx = re.compile(pattern) if pattern else None
        return sum(e - s for s, e, c, n in self.device
                   if (cat is None or c == cat)
                   and (rx is None or rx.search(n)))

    def count(self, cat, pattern=None):
        rx = re.compile(pattern) if pattern else None
        return sum(1 for _, _, c, n in self.device
                   if c == cat and (rx is None or rx.search(n)))

    def top_ops(self, n=TOP):
        by = {}
        for s, e, _, name in self.device:
            by[name[:96]] = by.get(name[:96], 0.0) + (e - s)
        return sorted(([k, v] for k, v in by.items()),
                      key=lambda kv: -kv[1])[:n]

    def idle_gaps(self, n=TOP):
        """The device's idle time in the window, summed by the innermost
        host span open at each gap's midpoint, largest sum first."""
        busy = self.busy_intervals()
        edges = [self.start] + [x for iv in busy for x in iv] + [self.end]
        starts = [h[0] for h in self.host]
        by = {}
        for a, b in zip(edges[0::2], edges[1::2]):
            if b <= a:
                continue
            mid = 0.5 * (a + b)
            i = bisect.bisect_right(starts, mid)
            # the latest-starting span still open is the innermost
            best = next((h for h in reversed(self.host[max(0, i - 4000):i])
                         if h[1] > mid), None)
            label = 'host: ' + (best[2][:80] if best else 'no span')
            by[label] = by.get(label, 0.0) + (b - a)
        return sorted(([k, v] for k, v in by.items()),
                      key=lambda kv: -kv[1])[:n]


@contextmanager
def profile(holder):
    """Profile the block with CPU and CUDA activity; on exit,
    `holder['trace']` holds its `Trace`. The chrome trace goes through
    a temporary file under TMPDIR, deleted once read."""
    import torch
    from torch.profiler import ProfilerActivity
    from torch.profiler import profile as tprofile
    acts = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(ProfilerActivity.CUDA)
    with tprofile(activities=acts) as prof:
        yield
    fd, path = tempfile.mkstemp(suffix='.json')
    os.close(fd)
    try:
        prof.export_chrome_trace(path)
        with open(path) as f:
            events = json.load(f)['traceEvents']
    finally:
        os.remove(path)
    holder['trace'] = Trace(events)


def step_span(name='bench.step'):
    import torch
    return torch.profiler.record_function(name)
