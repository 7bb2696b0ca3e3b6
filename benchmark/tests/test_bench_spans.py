"""The span reader (`harness/spans.py`) on a synthetic chrome trace: the
device's idle time splits by interval overlap into the parts under
`spt.batch`, under other `spt.*` spans and under none, adding up to
`idle_pct`; device time goes to the `spt.*` span that launched it, by
correlation id, whatever the thread; without spans every reader reads
nothing."""
import os
import types

import pytest

from benchmark.harness import spans
from benchmark.harness.readers import idle_pct
from benchmark.harness.runner import BENCH_DIR, reader
from benchmark.harness.trace import Trace

MAIN, AUTOGRAD, STREAM = 1, 2, 7
NAMES = ('batch_host_ms', 'batch_idle_pct', 'dispatch_idle_pct',
         'gather_ms', 'h2d_mb')


def _span(name, ts, dur, tid=MAIN, cat='user_annotation'):
    return {'ph': 'X', 'cat': cat, 'name': name, 'ts': ts, 'dur': dur,
            'tid': tid}


def _kernel(corr, launch, ts, dur, tid=MAIN, name='k'):
    """A runtime launch at `launch` on thread `tid` and its kernel,
    running on the stream from `ts` for `dur` (us)."""
    return [{'ph': 'X', 'cat': 'cuda_runtime', 'name': 'cudaLaunchKernel',
             'ts': launch, 'dur': 1.0, 'tid': tid,
             'args': {'correlation': corr}},
            {'ph': 'X', 'cat': 'kernel', 'name': name, 'ts': ts, 'dur': dur,
             'tid': STREAM, 'args': {'correlation': corr}}]


def _step(t0, with_spans=True):
    """One 100 us step from `t0`: the batch boundary (0-30 us), the
    forward (30-60) with a gather, the backward (60-90) whose gather runs
    on the autograd thread, then 10 us of Python under no span. The
    device runs a copy at 20-25, kernels at 40-50, 70-75 (the gather
    launched at 65 on the autograd thread, run after its span closed)
    and 80-85."""
    ev = []
    if with_spans:
        ev += [_span('spt.batch', t0, 30), _span('spt.loss', t0 + 30, 30),
               _span('spt.forward', t0 + 31, 28),
               _span('spt.gather', t0 + 35, 5),
               _span('spt.backward', t0 + 60, 30),
               _span('spt.gather', t0 + 64, 3, tid=AUTOGRAD)]
    c = int(t0) * 10 + 10
    ev += [{'ph': 'X', 'cat': 'cuda_runtime', 'name': 'cudaMemcpyAsync',
            'ts': t0 + 19, 'dur': 1.0, 'tid': MAIN,
            'args': {'correlation': c}},
           {'ph': 'X', 'cat': 'gpu_memcpy', 'name': 'Memcpy HtoD',
            'ts': t0 + 20, 'dur': 5.0, 'tid': STREAM,
            'args': {'correlation': c}}]
    ev += _kernel(c + 1, t0 + 36, t0 + 40, 10, name='gather')
    ev += _kernel(c + 2, t0 + 65, t0 + 70, 5, tid=AUTOGRAD, name='gather')
    ev += _kernel(c + 3, t0 + 78, t0 + 80, 5)
    return ev


def _trace(steps=2, with_spans=True):
    ev = [_span('bench.step', 100.0 * k, 100) for k in range(steps)]
    for k in range(steps):
        ev += _step(100.0 * k, with_spans)
    ev.append(_span('bench.sync', 100.0 * steps, 0.5))
    return Trace(ev)


def _run(trace, train=True):
    return {'trace': trace, 'train': train}


def test_the_idle_split_adds_up_to_idle_pct():
    t = _trace()
    split = spans.idle_split(t)
    # a step is idle 75 of 100 us: 25 under spt.batch (0-20, 25-30), 40
    # under the others (30-40, 50-70, 75-80, 85-90) and 10 under none
    # (90-100); the sync adds 0.5 us, under none
    assert split['batch_s'] == pytest.approx(2 * 25e-6)
    assert split['dispatch_s'] == pytest.approx(2 * 40e-6)
    assert split['none_s'] == pytest.approx(2 * 10e-6 + 0.5e-6)
    assert split['batch_s'] + split['dispatch_s'] + split['none_s'] \
        == pytest.approx(split['idle_s'])
    run = _run(t)
    assert spans.batch_idle_pct(run, True) \
        + spans.dispatch_idle_pct(run, True) \
        + 100.0 * split['none_s'] / split['window_s'] \
        == pytest.approx(idle_pct(run, True))


def test_a_gap_splits_by_overlap_not_by_its_midpoint():
    # one step, idle from 0 to 100 us; spt.batch covers 0-40: its
    # midpoint (50) is outside, yet 40 us of the gap are the batch's
    ev = [_span('bench.step', 0, 100), _span('spt.batch', 0, 40),
          _span('spt.loss', 60, 20), _span('bench.sync', 100, 1),
          {'ph': 'X', 'cat': 'kernel', 'name': 'k', 'ts': 100.5,
           'dur': 0.5, 'tid': STREAM}]
    split = spans.idle_split(Trace(ev))
    assert split['batch_s'] == pytest.approx(40e-6)
    assert split['dispatch_s'] == pytest.approx(20e-6)
    assert split['none_s'] == pytest.approx(40.5e-6)


def test_device_time_goes_to_the_span_that_launched_it():
    by = spans.device_by_span(_trace())
    # each step: the forward's gather (10 us) and the backward's (5 us,
    # launched on the autograd thread, run after its span closed)
    assert by['spt.gather'] == pytest.approx(2 * 15e-6)
    assert by['spt.batch'] == pytest.approx(2 * 5e-6)
    assert by['spt.backward'] == pytest.approx(2 * 5e-6)
    assert spans.gather_ms(_run(_trace()), True) == pytest.approx(15e-3)


def test_an_enclosing_span_that_starts_with_its_child_is_not_innermost():
    ev = [_span('bench.step', 0, 100), _span('spt.forward', 10, 50),
          _span('spt.gather', 10, 5), _span('bench.sync', 100, 1)]
    ev += _kernel(1, 12, 20, 4) + _kernel(2, 30, 35, 3)
    by = spans.device_by_span(Trace(ev))
    assert by == pytest.approx({'spt.gather': 4e-6, 'spt.forward': 3e-6})


def test_batch_host_ms_is_the_batch_spans_time_a_step():
    assert spans.batch_host_ms(_run(_trace(steps=3)), True) \
        == pytest.approx(30e-3)


def test_h2d_mb_reads_the_programs_counters(monkeypatch):
    fn = lambda: None  # noqa: E731
    fn.calls, fn.bytes = 4, 10_000_000
    monkeypatch.setitem(spans.sys.modules, spans.PADDED,
                        types.SimpleNamespace(from_numpy=fn))
    assert spans.h2d_mb(_run(_trace()), True) == pytest.approx(2.5)
    assert spans.h2d_mb(_run(_trace(), train=False), True) is None
    del fn.calls, fn.bytes   # a program without the counters
    assert spans.h2d_mb(_run(_trace()), True) is None


@pytest.mark.parametrize('name', NAMES)
@pytest.mark.parametrize('kind', ['train', 'serve'])
def test_every_reader_reads_nothing_without_spans(name, kind):
    read = reader(f'{name}.{kind}')
    train = kind == 'train'
    assert read({'trace': None, 'train': train}) is None
    assert read(_run(_trace(with_spans=False), train)) is None
    assert read(_run(_trace(), not train)) is None
    assert os.path.exists(os.path.join(BENCH_DIR, 'metrics',
                                       f'{name}.{kind}.py'))
