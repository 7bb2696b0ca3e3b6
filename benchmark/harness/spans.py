"""The program's own spans in a traced stretch, read against the device.

The port opens named host spans at its layer boundaries
(`superpoint_transformer_torch/utils/profiling.py:annotate`, names
`spt.*`): `spt.batch` around the host-to-device boundary (`from_numpy`),
`spt.loss`, `spt.forward`, the stages, `spt.backward`, `spt.optim`,
`spt.metrics`, `spt.fetch` and `spt.gather` inside the model step. The
spans share the clock of the device trace, so:

- each idle gap of the device (`Trace.busy_intervals`' complement in the
  window) splits, by interval overlap, into the part under a `spt.batch`
  span, the part under any other `spt.*` span (and no `spt.batch`), and
  the part under none; the three add up to the idle time;
- each device event goes to the innermost `spt.*` span open at its
  launch (the runtime call of its correlation id), on whatever thread.

Every reader returns None where the run has no trace, or where the trace
holds no `spt.` span (a program without them).
"""
import sys

__all__ = ['PREFIX', 'BATCH', 'GATHER', 'program_spans', 'idle_split',
           'device_by_span', 'batch_host_ms', 'batch_idle_pct',
           'dispatch_idle_pct', 'gather_ms', 'h2d_mb']

PREFIX = 'spt.'
BATCH = 'spt.batch'
GATHER = 'spt.gather'
PADDED = 'superpoint_transformer_torch.data.padded'


def program_spans(trace):
    """The trace's `spt.*` host spans inside the window, clipped to it,
    as (start, end, name) in order of start, an enclosing span before
    the spans it encloses that start with it."""
    return sorted(((max(s, trace.start), min(e, trace.end), n)
                   for s, e, n in trace.host
                   if n.startswith(PREFIX) and e > trace.start
                   and s < trace.end), key=lambda x: (x[0], -x[1]))


def _union(intervals):
    out = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        elif e > s:
            out.append([s, e])
    return out


def _overlap(a, b):
    """The length of the intersection of two sorted lists of disjoint
    intervals."""
    i = j = 0
    total = 0.0
    while i < len(a) and j < len(b):
        lo, hi = max(a[i][0], b[j][0]), min(a[i][1], b[j][1])
        if hi > lo:
            total += hi - lo
        if a[i][1] < b[j][1]:
            i += 1
        else:
            j += 1
    return total


def _idle(trace):
    edges = [trace.start] + [x for iv in trace.busy_intervals()
                             for x in iv] + [trace.end]
    return [[a, b] for a, b in zip(edges[0::2], edges[1::2]) if b > a]


def idle_split(trace):
    """Seconds of the window in which the device is idle: in all
    ('idle_s'), while the host is in a `spt.batch` span ('batch_s'), in
    another `spt.*` span and no `spt.batch` ('dispatch_s'), in none
    ('none_s'); and 'window_s'. None without `spt.*` spans."""
    spans = program_spans(trace)
    if not spans:
        return None
    idle = _idle(trace)
    idle_s = sum(b - a for a, b in idle)
    batch_s = _overlap(idle, _union((s, e) for s, e, n in spans
                                    if n == BATCH))
    any_s = _overlap(idle, _union((s, e) for s, e, _ in spans))
    return {'idle_s': idle_s, 'batch_s': batch_s,
            'dispatch_s': any_s - batch_s, 'none_s': idle_s - any_s,
            'window_s': trace.window_s}


def device_by_span(trace):
    """Device seconds by the innermost `spt.*` span open at each event's
    launch (the latest-starting one still open, on any thread), '' for
    events launched under none. None without `spt.*` spans."""
    spans = program_spans(trace)
    if not spans:
        return None
    by, open_, k = {}, [], 0
    for t, dur, _, _ in trace._launched:
        while k < len(spans) and spans[k][0] <= t:
            open_.append(spans[k])
            k += 1
        # a span on top that has closed stays closed: t only grows
        while open_ and open_[-1][1] < t:
            open_.pop()
        name = open_[-1][2] if open_ else ''
        by[name] = by.get(name, 0.0) + dur
    return by


def _trace(run, train):
    t = run['trace']
    if t is None or run['train'] != train or not program_spans(t):
        return None
    return t


def batch_host_ms(run, train):
    """Host time in `spt.batch` spans a step or request of the traced
    stretch, in ms."""
    t = _trace(run, train)
    if t is None:
        return None
    spans = _union((s, e) for s, e, n in program_spans(t) if n == BATCH)
    return 1e3 * sum(e - s for s, e in spans) / t.steps


def batch_idle_pct(run, train):
    """The share of the traced window in which the device is idle while
    the host is in a `spt.batch` span, in %."""
    t = _trace(run, train)
    if t is None:
        return None
    split = idle_split(t)
    return 100.0 * split['batch_s'] / split['window_s']


def dispatch_idle_pct(run, train):
    """The share of the traced window in which the device is idle while
    the host is in a `spt.*` span other than `spt.batch`, in %. Writes
    the whole split, and the device time by span, to standard error."""
    t = _trace(run, train)
    if t is None:
        return None
    split = idle_split(t)
    w = split['window_s']
    print('spans: idle {:.3f}% of the window: {:.3f}% under spt.batch, '
          '{:.3f}% under other spt.* spans, {:.3f}% under none'.format(
              *(100.0 * split[k] / w for k in ('idle_s', 'batch_s',
                                               'dispatch_s', 'none_s'))),
          file=sys.stderr)
    rows = sorted(device_by_span(t).items(), key=lambda kv: -kv[1])
    print('spans: device ms a step by innermost span at launch: '
          + ', '.join(f'{n or "none"} {1e3 * v / t.steps:.3f}'
                      for n, v in rows), file=sys.stderr)
    return 100.0 * split['dispatch_s'] / w


def gather_ms(run, train):
    """Device time of the events launched inside `spt.gather` spans
    (the gathers, forward and backward) a step or request of the traced
    stretch, in ms."""
    t = _trace(run, train)
    if t is None:
        return None
    return 1e3 * device_by_span(t).get(GATHER, 0.0) / t.steps


def h2d_mb(run, train):
    """MB that the program's batch boundary ships to the card a call
    (`from_numpy.bytes / from_numpy.calls`, the program's own counters,
    read after the run). None where the program has no such counters or
    counted no call."""
    if _trace(run, train) is None:
        return None
    fn = getattr(sys.modules.get(PADDED), 'from_numpy', None)
    calls = getattr(fn, 'calls', 0)
    if not calls:
        return None
    return getattr(fn, 'bytes', 0) / calls / 1e6
