"""The port's run utilities: `utils/memory.py` (OOM classification,
`task_wrapper`, `garbage_collection`, `device_memory_stats`,
`tune_host_allocator` and its call at package import),
`utils/profiling.py` (`Timings`, `trace`, `annotate`) and
`debug.py` (`set_debug` and the validators of the port's `Data`, `NAG`
and CSR containers), on the CPU; the OOM markers and the validators
against the JAX package's on the same inputs."""
import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from superpoint_transformer_tpu import debug as jdebug
from superpoint_transformer_tpu.utils import memory as jmemory
import superpoint_transformer_torch as port
from superpoint_transformer_torch import debug
from superpoint_transformer_torch.data.csr import Cluster
from superpoint_transformer_torch.data.data import Data
from superpoint_transformer_torch.data.nag import NAG
from superpoint_transformer_torch.utils import memory, profiling
from superpoint_transformer_torch.utils.synthetic import random_nag

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.mark.parametrize('exc, oom', [
    (MemoryError(), True),
    (torch.cuda.OutOfMemoryError('CUDA out of memory. Tried to allocate '
                                 '2.00 GiB'), True),
    (RuntimeError('CUDA error: out of memory'), True),
    (RuntimeError("DefaultCPUAllocator: can't allocate memory: you tried "
                  'to allocate 1099511627776 bytes'), True),
    (RuntimeError('Failed to allocate 12 bytes'), True),
    (RuntimeError('index 3 is out of bounds'), False),
    (ValueError('bad shape'), False)],
    ids=['memory_error', 'cuda_oom', 'cuda_error', 'cpu_allocator',
         'failed_to_allocate', 'index', 'value'])
def test_is_oom_error(exc, oom):
    assert memory.is_oom_error(exc) is oom


@pytest.mark.parametrize('msg', ['Out of memory', 'Failed to allocate',
                                 'nothing'])
def test_oom_markers_shared_with_jax(msg):
    """A message the JAX classifier reads as an OOM without naming XLA or
    Mosaic reads so here too."""
    e = RuntimeError(msg)
    assert memory.is_oom_error(e) == jmemory.is_oom_error(e)


def test_task_wrapper_reraises_and_flags_oom(capsys, monkeypatch):
    collected = []
    monkeypatch.setattr(memory, 'garbage_collection',
                        lambda: collected.append(True))

    @memory.task_wrapper
    def boom(kind):
        """Docstring kept."""
        raise kind('CUDA out of memory')

    with pytest.raises(torch.cuda.OutOfMemoryError):
        boom(torch.cuda.OutOfMemoryError)
    out = capsys.readouterr()
    assert 'Traceback' in out.err and 'out of memory' in out.out
    assert collected == [True]
    assert boom.__doc__ == 'Docstring kept.'

    @memory.task_wrapper
    def fine(x):
        return x + 1

    assert fine(1) == 2
    with pytest.raises(KeyError):
        memory.task_wrapper(lambda: {}['k'])()
    assert collected == [True]


def test_garbage_collection_and_memory_stats_without_a_card():
    memory.garbage_collection()
    stats = memory.device_memory_stats()
    if torch.cuda.is_available():
        assert sorted(stats) == [f'cuda:{i}'
                                 for i in range(torch.cuda.device_count())]
    else:
        assert stats == {}


_IMPORT = ('import json, superpoint_transformer_torch.utils.memory as m; '
           'print(json.dumps([m._MALLOC_TUNED, m.tune_host_allocator()]))')


@pytest.mark.parametrize('opt_out', [False, True])
def test_package_import_tunes_the_allocator_unless_opted_out(opt_out):
    """Importing the package tunes glibc malloc once (a second call is a
    no-op), unless SPT_NO_MALLOC_TUNING is set."""
    env = {k: v for k, v in os.environ.items()
           if k != 'SPT_NO_MALLOC_TUNING'}
    if opt_out:
        env['SPT_NO_MALLOC_TUNING'] = '1'
    env['PYTHONPATH'] = REPO
    out = subprocess.run([sys.executable, '-c', _IMPORT], env=env,
                         capture_output=True, text=True, timeout=120,
                         check=True)
    tuned, again = json.loads(out.stdout.strip().splitlines()[-1])
    assert tuned is (not opt_out) and again is False


def test_timer_and_timings():
    t = profiling.Timings()
    for _ in range(2):
        with t.track('x'):
            pass
    with pytest.raises(ZeroDivisionError):
        with t.track('y'):
            1 / 0
    assert t.counts == {'x': 2, 'y': 1}
    assert t.summary().splitlines()[0].split()[0] in ('x', 'y')


def test_trace_writes_a_chrome_trace_with_the_annotation(tmp_path):
    with profiling.trace(str(tmp_path / 'trace')) as prof:
        with profiling.annotate('spt_span'):
            torch.ones(64, 64) @ torch.ones(64, 64)
    names = {e.key for e in prof.key_averages()}
    assert 'spt_span' in names
    events = json.load(open(tmp_path / 'trace' / 'trace.json'))
    assert any(e.get('name') == 'spt_span'
               for e in events['traceEvents'])


@pytest.fixture
def debug_on():
    assert not port.is_debug_enabled()
    port.set_debug(True)
    assert debug.is_debug_enabled()
    yield
    port.set_debug(False)


def test_debug_validates_a_bad_csr(debug_on):
    bad = Cluster(np.array([0, 3, 2]), np.arange(3))
    with pytest.raises(ValueError, match='nondecreasing'):
        debug.validate_csr(bad)
    with pytest.raises(AssertionError, match='nondecreasing'):
        jdebug.validate_csr(bad)
    short = Cluster(np.array([0, 2, 5]), np.arange(4))
    with pytest.raises(ValueError, match='value length'):
        debug.validate_csr(short)
    # a Data holding it raises at construction
    with pytest.raises(ValueError):
        Data(pos=np.zeros((2, 3), np.float32), sub=bad)


def test_debug_validates_data_and_nag(debug_on):
    nag = random_nag(seed=0)
    NAG([nag[i] for i in nag.levels])            # valid: no raise
    with pytest.raises(ValueError, match='edge index out of range'):
        Data(pos=np.zeros((3, 3), np.float32),
             edge_index=np.array([[0, 1], [1, 3]]))
    d1 = nag[1]
    d1['super_index'] = np.full(d1.num_nodes, nag[2].num_nodes)
    with pytest.raises(ValueError, match='super_index exceeds'):
        NAG([nag[0], d1, nag[2]])


def test_debug_off_builds_without_checks():
    assert not port.is_debug_enabled()
    Data(pos=np.zeros((3, 3), np.float32),
         edge_index=np.array([[0, 1], [1, 3]]))
