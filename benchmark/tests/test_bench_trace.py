"""The trace reader: device events go to the step whose span launched
them, and a kernel's roofline reads the steps whose launches the trace
holds in full, leaving out one that lost a record."""
import os

import pytest

from benchmark.harness.cost import attention_launches, kernel_bound_s, peaks
from benchmark.harness.readers import roofline
from benchmark.harness.runner import BENCH_DIR, load_json
from benchmark.harness.trace import Trace

CARD = 'NVIDIA H100 80GB HBM3'
K2 = 'void dense_attention_rpe_kernel<__nv_bfloat16, 8, 2>(...)'
SIZES = [[(1000, 0), (120, 3000), (40, 900), (16, 300)],
         [(1100, 0), (130, 3100), (44, 950), (17, 320)]]


def _events(model, stretch, drop=None):
    """A chrome trace of `stretch`'s requests, one after the other: each
    step span launches its K2 calls (10 us each, run 5 us after their
    launch) and a copy; `drop` = (step, call) loses one kernel record."""
    ev, corr, t = [], 1, 0.0
    for k, i in enumerate(stretch):
        calls = len(attention_launches(model, SIZES[i]))
        ev.append({'ph': 'X', 'cat': 'user_annotation', 'name': 'bench.step',
                   'ts': t, 'dur': 40.0 * calls + 50})
        for c in range(calls):
            launch = t + 40.0 * c + 10
            ev.append({'ph': 'X', 'cat': 'cuda_runtime',
                       'name': 'cudaLaunchKernel', 'ts': launch, 'dur': 2.0,
                       'args': {'correlation': corr}})
            if drop != (k, c):
                ev.append({'ph': 'X', 'cat': 'kernel', 'name': K2,
                           'ts': launch + 5, 'dur': 10.0,
                           'args': {'correlation': corr}})
            corr += 1
        ev.append({'ph': 'X', 'cat': 'cuda_runtime',
                   'name': 'cudaMemcpyAsync', 'ts': t + 1, 'dur': 2.0,
                   'args': {'correlation': corr}})
        ev.append({'ph': 'X', 'cat': 'gpu_memcpy', 'name': 'Memcpy HtoD',
                   'ts': t + 2, 'dur': 3.0, 'args': {'correlation': corr}})
        corr += 1
        t += 40.0 * calls + 60
    ev.append({'ph': 'X', 'cat': 'user_annotation', 'name': 'bench.sync',
               'ts': t, 'dur': 5.0})
    return ev


def _run(model, stretch, drop=None):
    return {'trace': Trace(_events(model, stretch, drop)), 'kind_name': CARD,
            'train': False, 'stretch': stretch, 'sizes': SIZES,
            'model': model}


@pytest.fixture(scope='module')
def model():
    return load_json(BENCH_DIR, 'configs', 'spt3_dales.json')['model']


def test_device_events_go_to_the_step_that_launched_them(model):
    t = _run(model, [0, 1, 0])['trace']
    calls = [len(attention_launches(model, SIZES[i])) for i in (0, 1, 0)]
    assert [len(d) for d in t.per_step('kernel', 'dense_attention_rpe')] \
        == calls
    assert [len(d) for d in t.per_step('gpu_memcpy')] == [1, 1, 1]
    assert t.count('kernel') == sum(calls)


@pytest.mark.parametrize('drop', [None, (1, 3)])
def test_roofline_reads_the_steps_whose_launches_are_all_there(model, drop):
    stretch = [0, 1, 0]
    got = roofline(_run(model, stretch, drop), False, 'K2',
                   r'\bdense_attention_rpe_kernel\b')
    kept = [i for k, i in enumerate(stretch) if drop is None or k != drop[0]]
    bound = sum(kernel_bound_s('K2', model, SIZES[i], peaks(CARD))
                for i in kept)
    seconds = 10e-6 * sum(len(attention_launches(model, SIZES[i]))
                          for i in kept)
    assert got == pytest.approx(100.0 * bound / seconds, rel=1e-9)


def test_roofline_reads_nothing_without_the_kernel(model):
    run = _run(model, [0, 1])
    assert roofline(run, False, 'K1', r'\bdense_attention_kernel\b') is None
    assert roofline(run, True, 'K2', r'\bdense_attention_rpe_kernel\b') \
        is None


def test_the_table_of_peaks_has_the_card():
    assert os.path.exists(os.path.join(BENCH_DIR, 'harness', 'peaks.json'))
    assert peaks(CARD)['bytes_s'] > 0
