"""The GraphNorm span reader (`harness/norm_spans.py`) on a synthetic
chrome trace: the device time of the kernels launched while `spt.norm`
is open, the gathers inside it included, a request; nothing without the
span, without a trace or in a training run."""
import pytest

from benchmark.harness.norm_spans import norm_ms
from benchmark.harness.runner import reader
from benchmark.harness.trace import Trace

MAIN, STREAM = 1, 7


def _span(name, ts, dur):
    return {'ph': 'X', 'cat': 'user_annotation', 'name': name, 'ts': ts,
            'dur': dur, 'tid': MAIN}


def _kernel(corr, launch, ts, dur):
    return [{'ph': 'X', 'cat': 'cuda_runtime', 'name': 'cudaLaunchKernel',
             'ts': launch, 'dur': 1.0, 'tid': MAIN,
             'args': {'correlation': corr}},
            {'ph': 'X', 'cat': 'kernel', 'name': 'k', 'ts': ts, 'dur': dur,
             'tid': STREAM, 'args': {'correlation': corr}}]


def _trace(steps=2, with_spans=True):
    """Requests of 100 us: the forward (0-60) with two norms (10-20, a
    gather inside at 12-14, and 40-45). Kernels: 11-13 (launched at 11,
    in the first norm), 13-16 (at 13, in its gather), 30-35 (at 25,
    between the norms), 41-44 (at 41, in the second) and 70-72 (at 65,
    after the forward)."""
    ev = [_span('bench.step', 100.0 * k, 100) for k in range(steps)]
    for k in range(steps):
        t = 100.0 * k
        if with_spans:
            ev += [_span('spt.forward', t, 60), _span('spt.norm', t + 10, 10),
                   _span('spt.gather', t + 12, 2),
                   _span('spt.norm', t + 40, 5)]
        c = 10 * k + 1
        for i, (at, ts, dur) in enumerate(((11, 11, 2), (13, 13, 3),
                                           (25, 30, 5), (41, 41, 3),
                                           (65, 70, 2))):
            ev += _kernel(c + i, t + at, t + ts, dur)
    ev.append(_span('bench.sync', 100.0 * steps, 0.5))
    return Trace(ev)


def test_norm_ms_reads_the_kernels_launched_in_the_norms():
    run = {'trace': _trace(), 'train': False}
    # 2 + 3 + 3 us a request: the norms' kernels and the gather's
    assert norm_ms(run) == pytest.approx(0.008)
    assert reader('norm_ms.serve')(run) == pytest.approx(0.008)


@pytest.mark.parametrize('run', [
    {'trace': _trace(with_spans=False), 'train': False},
    {'trace': None, 'train': False},
    {'trace': _trace(), 'train': True}], ids=['no_span', 'untraced', 'train'])
def test_norm_ms_reads_nothing_without_the_span(run):
    assert reader('norm_ms.serve')(run) is None


def test_launched_ms_reads_any_span_and_the_spans_inside_it():
    from benchmark.harness.norm_spans import launched_ms
    run = {'trace': _trace(), 'train': False}
    # the gather's kernel alone, 3 us a request; the forward's three
    assert launched_ms(run, 'spt.gather') == pytest.approx(0.003)
    assert launched_ms(run, 'spt.forward') == pytest.approx(0.013)
    assert launched_ms(run, 'spt.partition') is None
