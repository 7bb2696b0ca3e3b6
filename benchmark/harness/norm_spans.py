"""GraphNorm's span in a traced stretch, read against the device:
`spt.norm`, around every `nn/norm.py:GraphNorm` forward of the program
(its fused kernels, or the segment sums, gathers and casts of its
PyTorch path, the gathers in their own `spt.gather` spans inside it).

`launched_ms` reads any program span so; `norm_ms` is `spt.norm`'s. They
return None where the run has no trace, is a training run, or where the
trace holds no such span (a program without it).
"""
import bisect

from .spans import program_spans

__all__ = ['NORM', 'launched_ms', 'norm_ms']

NORM = 'spt.norm'


def launched_ms(run, span):
    """Device time of the events launched while a `span` span is open
    (the spans inside it included) a request of the traced stretch, in
    ms."""
    t = run['trace']
    if t is None or run['train']:
        return None
    spans = []
    for s, e, n in program_spans(t):
        if n != span:
            continue
        if spans and s <= spans[-1][1]:
            spans[-1][1] = max(spans[-1][1], e)
        elif e > s:
            spans.append([s, e])
    if not spans:
        return None
    starts = [s for s, _ in spans]
    total = 0.0
    for at, dur, _, _ in t._launched:
        k = bisect.bisect_right(starts, at) - 1
        if k >= 0 and at <= spans[k][1]:
            total += dur
    return 1e3 * total / t.steps


def norm_ms(run):
    """`launched_ms` of `spt.norm`: GraphNorm's device time a request."""
    return launched_ms(run, NORM)
