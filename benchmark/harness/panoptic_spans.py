"""The panoptic program's spans and counters in a traced stretch, read
against the device (as `spans.py` reads the batch boundary's):

- `spt.affinity`, around the edge-affinity head in the forward
  (`models/panoptic.py:PanopticSegmentationModel`), its gathers in their
  own `spt.gather` spans inside it;
- `spt.partition`, around the host partition of level 1 and the
  instance classes (`inference.py:infer_panoptic_batch`);
- the counters `instance_partition.calls`, `.nodes`, `.edges` and
  `.instances` (`models/panoptic.py`).

Every reader returns None where the run has no trace, or where the
trace holds no such span (a program without them).
"""
import bisect
import sys

from .spans import _idle, _overlap, _union, program_spans

__all__ = ['AFFINITY', 'PARTITION', 'partition_host_ms',
           'partition_idle_pct', 'affinity_ms', 'partition_edges']

AFFINITY = 'spt.affinity'
PARTITION = 'spt.partition'
PANOPTIC = 'superpoint_transformer_torch.models.panoptic'


def _spans(run, name):
    """The stretch's trace and the union of its `name` spans, or None."""
    t = run['trace']
    if t is None or run['train']:
        return None
    spans = _union((s, e) for s, e, n in program_spans(t) if n == name)
    return (t, spans) if spans else None


def partition_host_ms(run):
    """Host time in `spt.partition` spans a request of the traced
    stretch, in ms."""
    got = _spans(run, PARTITION)
    if got is None:
        return None
    t, spans = got
    return 1e3 * sum(e - s for s, e in spans) / t.steps


def partition_idle_pct(run):
    """The share of the traced window in which the device is idle while
    the host is in a `spt.partition` span, in %."""
    got = _spans(run, PARTITION)
    if got is None:
        return None
    t, spans = got
    return 100.0 * _overlap(_idle(t), spans) / t.window_s


def affinity_ms(run):
    """Device time of the events launched while a `spt.affinity` span is
    open (the head's gathers included) a request of the traced stretch,
    in ms."""
    got = _spans(run, AFFINITY)
    if got is None:
        return None
    t, spans = got
    starts = [s for s, _ in spans]
    total = 0.0
    for at, dur, _, _ in t._launched:
        k = bisect.bisect_right(starts, at) - 1
        if k >= 0 and at <= spans[k][1]:
            total += dur
    return 1e3 * total / t.steps


def partition_edges(run):
    """Instance-graph edges a partition (`instance_partition.edges /
    .calls`, the program's own counters, read after the run). None
    without a trace, or where the program has no such counters or made
    no partition."""
    if run['trace'] is None or run['train']:
        return None
    fn = getattr(sys.modules.get(PANOPTIC), 'instance_partition', None)
    calls = getattr(fn, 'calls', 0)
    if not calls:
        return None
    return getattr(fn, 'edges', 0) / calls
