"""The panoptic serving cell on the CPU at a small size, the program in
f32 (`benchmark/conftest.py`): its kind runs through the harness,
reports the cell's metrics and is correct; the check fails the float8
control and every fault of `panoptic_faults.py` by the number made to
catch it; the reference's greedy partition reaches the brute-force
optimum on small graphs with one; the span readers read a synthetic
trace; the reference loads nothing of the program."""
import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from benchmark import panoptic_faults
from benchmark.calibrate_panoptic import control_numbers
from benchmark.harness import panoptic_spans
from benchmark.harness.runner import cell_files, metrics_of, reader, run_cell
from benchmark.harness.trace import Trace
from benchmark.reference import panoptic as ref

from bench_util import REPO, bench, clock, tiny_root

SEED = 2 ** 31 + 43
CELL = 'supercluster_dales.serve'
# the serving metrics whose readers do not depend on the model
GENERIC = ('h2d_ms.serve', 'launches.serve', 'idle_pct.serve',
           'batch_host_ms.serve', 'batch_idle_pct.serve',
           'dispatch_idle_pct.serve', 'gather_ms.serve', 'h2d_mb.serve')
NEW = ('partition_host_ms.serve', 'partition_idle_pct.serve',
       'affinity_ms.serve', 'partition_edges.serve')
# the number of the check made to catch each fault
CATCHES = {'shifted_affinity': 'affinity_gap', 'other_graph': None,
           'stuff_skipped': 'stuff_split',
           'unweighted_nodes': 'energy_gap'}
BENCH = bench()


@pytest.fixture(scope='module')
def root(tmp_path_factory):
    """The tiny benchmark directory (the program in f32:
    `benchmark/conftest.py`)."""
    return tiny_root(tmp_path_factory.mktemp('panoptic'))


@pytest.fixture(scope='module')
def sound(root):
    """A sound traced run of the cell and its limits."""
    res, lines = run_cell(BENCH, CELL, SEED, 1.0, 1, 'cpu', clock(),
                          root=root)
    return res, cell_files(BENCH, CELL, root)[3], lines


def _values(res):
    return {k: v['value'] for k, v in res['checks'].items()}


def test_the_kind_runs_and_reports_the_cell_metrics(root, sound):
    res, _, lines = sound
    assert res['correct'] and res['attempted'] > 0, lines
    assert all(res['metrics'][m]['value'] is not None for m in NEW), lines
    assert res['metrics']['partition_edges.serve']['value'] > 0
    assert set(res['checks']) == {'pred_gap_mean', 'affinity_gap',
                                  'energy_gap', 'stuff_split'}
    res, _ = run_cell(BENCH, CELL, SEED, 0.5, 0, 'cpu', clock(), root=root)
    assert set(res['metrics']) == {'serve_points_per_s', 'setup_s'}


def test_the_control_is_not_correct(root, sound):
    _, limits, _ = sound
    _, cfg, traffic, _ = cell_files(BENCH, CELL, root)
    numbers = control_numbers(cfg, traffic, SEED, torch.device('cpu'))
    assert numbers['pred_gap_mean'] > limits['pred_gap_mean'] \
        >= _values(sound[0])['pred_gap_mean'], numbers


@pytest.mark.parametrize('fault', panoptic_faults.FAULTS)
def test_each_fault_fails_the_number_made_to_catch_it(root, sound, fault):
    ok, limits, _ = sound
    with panoptic_faults.plant(fault):
        res, lines = run_cell(BENCH, CELL, SEED, 1.0, 0, 'cpu', clock(),
                              root=root)
    assert res['correct'] is False and res['attempted'] > 0, lines
    name = CATCHES[fault]
    if name is None:
        # another batch's graph has other edges: malformed answers, or
        # affinities of other pairs
        assert res['failed'] > 0 or _values(res)['affinity_gap'] > limits[
            'affinity_gap'], lines
    else:
        assert _values(res)[name] > limits[name] >= _values(ok)[name], lines


BELL = {5: 52, 6: 203, 7: 877, 8: 4140}


def _partitions(n):
    """Every partition of range(n), as component ids."""
    def grow(prefix, k):
        if len(prefix) == n:
            yield list(prefix)
            return
        for c in range(k + 1):
            yield from grow(prefix + [c], max(k, c + 1))
    yield from grow([0], 1)


@pytest.mark.parametrize('seed', range(6))
def test_the_greedy_partition_reaches_the_optimum_of_small_graphs(seed):
    """Graphs of 5-8 nodes in 2-4 groups, each with its own class and
    place, joined inside by edges of affinity logits 3-6 and between by
    sparser edges of -6 to -3: the brute-force optimum over every
    partition is the groups', and the greedy merge reaches its energy."""
    rng = np.random.default_rng(seed)
    n = int(rng.integers(5, 9))
    label = np.sort(rng.integers(0, int(rng.integers(2, 5)), n))
    label = np.unique(label, return_inverse=True)[1]
    pos = label[:, None] * 4.0 + rng.normal(0, 0.1, (n, 3))
    logits = rng.normal(0, 0.5, (n, 8)) + 6.0 * (
        np.arange(8)[None] == (label[:, None] % 8))
    u, v = np.triu_indices(n, 1)
    same = label[u] == label[v]
    keep = same | (rng.random(u.shape[0]) < 0.4)
    aff = np.where(same, rng.uniform(3, 6, u.shape[0]),
                   rng.uniform(-6, -3, u.shape[0]))[keep]
    edges = np.stack([u[keep], v[keep]])
    f, w, ew = ref.partition_inputs(pos, logits, aff,
                                    rng.integers(20, 200, n), 5e-2)
    parts = list(_partitions(n))
    assert len(parts) == BELL[n]
    e = [ref.energy(f, w, edges, ew, 10.0, p) for p in parts]
    greedy = ref.greedy_partition(f, w, edges, ew, 10.0, 1)
    assert ref.energy(f, w, edges, ew, 10.0, greedy) <= min(e) * (1 + 1e-12)
    assert ref.energy(f, w, edges, ew, 10.0, label) == pytest.approx(min(e))


def test_the_energy_is_the_l0_energy():
    f = np.array([[0.0, 0.0], [1.0, 0.0], [0.0, 2.0]])
    w = np.array([1.0, 3.0, 2.0])
    edges = np.array([[0, 1], [1, 2]])
    ew = np.array([0.5, 0.25])
    # {0, 1} with mean (0.75, 0) and {2}: 0.75^2 + 3 * 0.25^2, and the
    # cut edge (1, 2)
    assert ref.energy(f, w, edges, ew, 10.0, [0, 0, 1]) == pytest.approx(
        0.75 ** 2 + 3 * 0.25 ** 2 + 10.0 * 0.25)
    assert ref.energy(f, w, edges, ew, 10.0, [0, 1, 2]) == pytest.approx(
        10.0 * 0.75)


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
    """Steps of 100 us: the forward (0-50) with the affinity head
    (30-45) and a gather inside it (32-36), then the partition (60-90).
    Kernels: 10-25 (launched at 5), 33-35 (at 33, in the gather), 41-43
    (at 40, in the head), 50-55 (at 46, after it) and 70-72 (at 65,
    under the partition)."""
    ev = [_span('bench.step', 100.0 * k, 100) for k in range(steps)]
    for k in range(steps):
        t = 100.0 * k
        if with_spans:
            ev += [_span('spt.forward', t, 50),
                   _span('spt.affinity', t + 30, 15),
                   _span('spt.gather', t + 32, 4),
                   _span('spt.partition', t + 60, 30)]
        c = 10 * k + 1
        for i, (at, ts, dur) in enumerate(((5, 10, 15), (33, 33, 2),
                                           (40, 41, 2), (46, 50, 5),
                                           (65, 70, 2))):
            ev += _kernel(c + i, t + at, t + ts, dur)
    ev.append(_span('bench.sync', 100.0 * steps, 0.5))
    return Trace(ev)


def test_the_span_readers_read_a_synthetic_trace(monkeypatch):
    from superpoint_transformer_torch.models import panoptic
    run = {'trace': _trace(), 'train': False}
    # the partition spans 30 us a step; the card idles 28 us of them
    # (60-70, 72-90), over a window of 200.5 us
    assert panoptic_spans.partition_host_ms(run) == pytest.approx(0.030)
    assert panoptic_spans.partition_idle_pct(run) == pytest.approx(
        100 * 56 / 200.5)
    # the gather's kernel and the head's, not the one launched after it
    assert panoptic_spans.affinity_ms(run) == pytest.approx(0.004)
    for k, v in (('calls', 4), ('edges', 1000)):
        monkeypatch.setattr(panoptic.instance_partition, k, v)
    assert panoptic_spans.partition_edges(run) == 250
    for m in NEW:
        assert reader(m)(run) is not None
    bare = {'trace': _trace(with_spans=False), 'train': False}
    for m in NEW[:3]:
        assert reader(m)(bare) is None
    for m in NEW:
        assert reader(m)({'trace': None, 'train': False}) is None


def test_the_reference_loads_nothing_of_the_program():
    code = f'''
import json, sys
sys.path.insert(0, {REPO!r})
import benchmark.reference.panoptic
print(json.dumps(sorted({{m.split('.')[0] for m in sys.modules}})))
'''
    out = subprocess.run([sys.executable, '-c', code], cwd=REPO,
                         capture_output=True, text=True, timeout=600)
    assert out.returncode == 0, out.stderr[-3000:]
    tops = set(json.loads(out.stdout.strip().splitlines()[-1]))
    assert 'superpoint_transformer_torch' not in tops
    assert not tops & {'jax', 'jaxlib', 'flax', 'optax', 'orbax',
                       'superpoint_transformer_tpu'}


def test_the_cell_reports_setup_an_end_to_end_and_a_per_layer_metric():
    e2e = {m['name'] for m in metrics_of(BENCH, CELL, False)}
    layer = {m['name'] for m in metrics_of(BENCH, CELL, True)}
    assert e2e == {'serve_points_per_s', 'setup_s'}
    assert layer == set(GENERIC) | set(NEW)
    for m in layer:
        assert os.path.exists(os.path.join(REPO, 'benchmark', 'metrics',
                                           m + '.py')), m
