"""The port's profiler spans and batch-boundary counters, on the CPU:
`utils/profiling.py:annotate` costs no dispatcher call while no profiler
runs; one traced training step and one traced request open every span
the benchmark's span metrics read (`benchmark/harness/spans.py`), nested
as the layers are; `from_numpy.bytes` counts the bytes shipped to a card
and `from_numpy.stage_waits` the waits on a staging slot (on a card
only); the inference phase timers synchronize only for a caller that
asked for timings, and open their phases as spans."""
import dataclasses

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from superpoint_transformer_torch import inference as tinf
from superpoint_transformer_torch.data.padded import from_numpy
from superpoint_transformer_torch.experiment import (FLAGSHIP_CFG,
                                                     build_model, build_task)
from superpoint_transformer_torch.models.semantic import (
    SemanticSegmentationModel)
from superpoint_transformer_torch.transforms.prepare import (BatchConfig,
                                                             process_batch)
from superpoint_transformer_torch.transforms.preprocess import (
    preprocess_cloud)
from superpoint_transformer_torch.utils import profiling
from superpoint_transformer_torch.utils.synthetic import (
    random_padded_nag, synthetic_room_cloud)

# the spans of one training step and one request of the flagship (two
# down stages, one up stage)
STEP_SPANS = ('spt.batch', 'spt.loss', 'spt.forward', 'spt.hf',
              'spt.stage.first', 'spt.stage.down0', 'spt.stage.down1',
              'spt.stage.up0', 'spt.backward', 'spt.optim', 'spt.metrics',
              'spt.gather', 'spt.norm')
REQUEST_SPANS = ('spt.batch', 'spt.forward', 'spt.fetch', 'spt.gather',
                 'spt.norm')
STAGES = ('spt.hf', 'spt.stage.first', 'spt.stage.down0',
          'spt.stage.down1', 'spt.stage.up0')
# the fast preprocessing settings of tests/test_inference.py
PRE = dict(voxel=0.1, knn=25, knn_r=10.0, knn_min_search=10,
           pcp_regularization=(0.1, 0.2, 0.3),
           pcp_spatial_weight=(0.1, 0.01, 0.001),
           pcp_cutoff=(10, 30, 100), graph_gap=(5.0, 30.0, 30.0))


def _host_batch(seed):
    return random_padded_nag(seed=seed, num_graphs=2, n_points=400,
                             n_l1=48, n_l2=12)


def _spans(prof):
    """{name: [(start us, end us), ...]} of the trace's `spt.*` spans."""
    out = {}
    for e in prof.events():
        if e.name.startswith('spt.'):
            out.setdefault(e.name, []).append(
                (e.time_range.start, e.time_range.end))
    return out


def _inside(inner, outer):
    return any(a <= s and e <= b for s, e in [inner] for a, b in outer)


@pytest.fixture(scope='module')
def traced():
    """The `spt.*` spans of one traced training step and of one traced
    request (a step and a request before them, untraced)."""
    torch.manual_seed(0)
    task = build_task(FLAGSHIP_CFG, num_graphs=2, total_steps=10,
                      device='cpu')
    cd = task.model.net.compute_dtype
    train, serve = _host_batch(3), _host_batch(4)
    task.train_step(from_numpy(train, 'cpu', cd, train=True))
    with profile(activities=[ProfilerActivity.CPU]) as step:
        task.train_step(from_numpy(train, 'cpu', cd, train=True))
    task.model.eval()
    tinf.infer_batch(task.model, from_numpy(serve, 'cpu', cd))
    with profile(activities=[ProfilerActivity.CPU]) as request:
        tinf.infer_batch(task.model, from_numpy(serve, 'cpu', cd))
    return _spans(step), _spans(request)


def test_annotate_off_returns_the_shared_null_context(monkeypatch):
    def refuse(name):
        raise AssertionError(f'record_function({name!r}) with no profiler')
    monkeypatch.setattr(torch.profiler, 'record_function', refuse)
    span = profiling.annotate('spt.test')
    assert span is profiling._OFF is profiling.annotate('spt.other')
    with span:
        pass


def test_annotate_on_is_record_function():
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        span = profiling.annotate('spt.test')
        assert isinstance(span, torch.profiler.record_function)
        with span:
            torch.ones(4) + 1
    assert 'spt.test' in _spans(prof)


@pytest.mark.parametrize('name', STEP_SPANS)
def test_a_training_step_opens_the_span(traced, name):
    assert name in traced[0], sorted(traced[0])


@pytest.mark.parametrize('name', REQUEST_SPANS)
def test_a_request_opens_the_span(traced, name):
    assert name in traced[1], sorted(traced[1])


def test_spans_nest_as_the_layers(traced):
    step, request = traced
    (loss,), (fwd,) = step['spt.loss'], step['spt.forward']
    assert _inside(fwd, [loss])
    for name in STAGES:
        assert all(_inside(s, [fwd]) for s in step[name]), name
    # gathers run in the stages and in the backward, norms in the forward
    assert any(_inside(g, step['spt.stage.down0'])
               for g in step['spt.gather'])
    assert all(_inside(n, [fwd]) for n in step['spt.norm'])
    assert any(_inside(g, step['spt.backward']) for g in step['spt.gather'])
    for name in ('spt.batch', 'spt.backward', 'spt.metrics'):
        assert not any(_inside(s, [loss]) for s in step[name]), name
    (fetch,), (rfwd,) = request['spt.fetch'], request['spt.forward']
    assert fetch[0] >= rfwd[1]
    assert 'spt.loss' not in request and 'spt.backward' not in request


def test_from_numpy_counts_nothing_on_the_cpu():
    calls, shipped = from_numpy.calls, from_numpy.bytes
    from_numpy(_host_batch(3), 'cpu', 'bf16', train=True)
    assert (from_numpy.calls, from_numpy.bytes) == (calls, shipped)


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip('needs an NVIDIA GPU: the counters count copies to a '
                    'card only')
    return torch.device('cuda', torch.cuda.current_device())


@pytest.mark.cuda
@pytest.mark.parametrize('train', [True, False],
                         ids=['pinned_train', 'pageable_serve'])
def test_from_numpy_counts_the_bytes_it_ships(cuda_device, train):
    calls, shipped = from_numpy.calls, from_numpy.bytes
    batch = from_numpy(_host_batch(3), cuda_device, 'bf16', train=train,
                       pin_memory=train)
    leaves = [getattr(lvl, f.name) for lvl in batch.levels
              for f in dataclasses.fields(lvl)
              if isinstance(getattr(lvl, f.name), torch.Tensor)]
    assert all(t.device.type == 'cuda' for t in leaves)
    assert any(t.dtype == torch.bfloat16 for t in leaves)
    assert any(t.dtype == torch.int64 for t in leaves)
    assert from_numpy.calls == calls + 1
    # the one copy moves each leaf at the dtype it crosses in, integers
    # as int32, each at a 512-byte offset
    crossing = sum(t.numel() * (4 if t.dtype == torch.int64
                                else t.element_size()) for t in leaves)
    assert crossing <= from_numpy.bytes - shipped \
        <= crossing + 511 * len(leaves)


@pytest.mark.cuda
def test_staging_waits_for_a_slot_whose_copy_still_runs(cuda_device):
    """The third of three batches takes the first one's slot while the
    first copy waits behind a sleep on the stream: it waits for it, and
    the first batch arrives whole."""
    hosts = [_host_batch(s) for s in (4, 5, 6)]
    waits = from_numpy.stage_waits
    torch.cuda._sleep(1_000_000_000)
    first = from_numpy(hosts[0], cuda_device, 'bf16')
    for h in hosts[1:]:
        from_numpy(h, cuda_device, 'bf16')
    assert from_numpy.stage_waits == waits + 1
    want = from_numpy(hosts[0], 'cpu', 'bf16')
    for lg, lw in zip(first.levels, want.levels):
        for f in dataclasses.fields(lw):
            w = getattr(lw, f.name)
            if isinstance(w, torch.Tensor):
                g = getattr(lg, f.name)
                assert g.dtype == w.dtype and torch.equal(g.cpu(), w), f.name


@pytest.fixture(scope='module')
def tiles():
    """Two small preprocessed rooms, a config pinned to their shared
    padded signature, and the flagship model on the CPU."""
    nags = [preprocess_cloud(synthetic_room_cloud(seed=s, n_points=5_000),
                             **PRE) for s in range(2)]
    cfg = dataclasses.replace(BatchConfig(), **tinf.EVAL_BATCH_OVERRIDES)
    torch.manual_seed(0)
    model = SemanticSegmentationModel(
        build_model(FLAGSHIP_CFG, num_graphs=1, device='cpu'), 13)
    model.eval()
    bigs = [process_batch([n], cfg, train=False) for n in nags]
    return nags, tinf.pin_signature(bigs, cfg), model


@pytest.mark.parametrize('path', ['infer_nag', 'infer_nags_stacked'])
def test_phase_timers_synchronize_only_when_asked(tiles, monkeypatch,
                                                  path):
    nags, cfg, model = tiles
    synced = []
    monkeypatch.setattr(tinf, '_sync', synced.append)

    def run(timings):
        if path == 'infer_nag':
            return [tinf.infer_nag(model, n, cfg, timings=timings)
                    for n in nags]
        return tinf.infer_nags_stacked(model, nags, cfg, timings=timings,
                                       warmup=True)
    quiet = run(None)
    assert synced == []
    timings = {}
    timed = run(timings)
    # the transfer and the forward (and the warm-up) end synchronized
    assert len(synced) == (4 if path == 'infer_nag' else 3)
    assert {'pad', 'transfer', 'forward'} <= set(timings)
    for a, b in zip(quiet, timed):
        np.testing.assert_array_equal(a, b)


def test_phases_open_spans(tiles):
    nags, cfg, model = tiles
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        tinf.infer_nags_stacked(model, nags, cfg, timings={}, warmup=True)
    spans = _spans(prof)
    for phase in ('pad', 'transfer', 'warmup_compile', 'forward', 'fetch'):
        assert f'spt.{phase}' in spans, sorted(spans)
    (transfer,) = spans['spt.transfer']
    assert _inside(spans['spt.batch'][0], [transfer])
