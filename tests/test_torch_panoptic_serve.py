"""SuperCluster's serving path in the port (`inference.infer_panoptic_batch`,
`experiment.PANOPTIC_DALES_CFG`) against the plain reference of the
benchmark (`benchmark/reference/panoptic.py`), on the CPU: the SPT-3
panoptic model at its configuration's widths in f32 on a tiny batch of
two tiles with a level-1 instance graph, weights drawn from a seed; the
partition on tiny graphs; the stuff merge; `strip_for_inference` on the
instance leaves; the spans and counters of the head and the partition."""
import json
import os

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from benchmark.harness.instance_traffic import make_panoptic_pool
from benchmark.harness.panoptic_weights import draw_panoptic_weights
from benchmark.reference import panoptic as ref
from superpoint_transformer_torch.data.padded import (from_numpy,
                                                      strip_for_inference)
from superpoint_transformer_torch.experiment import (PANOPTIC_DALES_CFG,
                                                     build_task,
                                                     partition_settings)
from superpoint_transformer_torch.inference import infer_panoptic_batch
from superpoint_transformer_torch.models import panoptic as tpan
from superpoint_transformer_torch.utils import profiling

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SEED = 2 ** 31 + 41
SETTINGS = partition_settings(PANOPTIC_DALES_CFG)
STUFF = tuple(PANOPTIC_DALES_CFG['datamodule']['stuff_classes'])


def _load(*parts):
    with open(os.path.join(REPO, 'benchmark', *parts)) as f:
        return json.load(f)


@pytest.fixture(scope='module')
def served():
    """The f32 program and the reference on one tiny batch: (task,
    host batch, answer, reference answer)."""
    cfg = _load('configs', 'supercluster_dales.json')
    traffic = _load('workloads', 'dales_panoptic_8tiles.json')
    sizes = (1500, 60, 16, 6)
    traffic = dict(traffic, graphs=2, pool=1, levels=[
        dict(lvl, nodes=n, **({'degree_mean': 6, 'degree_max': 11}
                              if 'degree_mean' in lvl else {}))
        for lvl, n in zip(traffic['levels'], sizes)],
        instance_graph={'edges_per_node': 1.0, 'degree_max': 6})
    host = make_panoptic_pool(cfg, traffic, SEED)[0][0]
    weights = draw_panoptic_weights(cfg['model'], SEED, torch.device('cpu'))
    task = build_task(PANOPTIC_DALES_CFG, num_graphs=2, device='cpu',
                      compute_dtype='float32')
    task.model.load_state_dict(weights)
    task.model.eval()
    assert task.stuff_classes == STUFF
    answer = infer_panoptic_batch(task, from_numpy(host, 'cpu'), host,
                                  SETTINGS)
    r = ref.answer(cfg['model'], weights, host, SETTINGS, STUFF,
                   torch.device('cpu'))
    return task, host, answer, r


def _host(a, r):
    return np.asarray(a)[r['node_id']]


def test_logits_and_affinities_meet_the_reference_in_f32(served):
    _, _, a, r = served
    assert r['edges'].shape[1] > 20
    # f32 on both sides, summed in other orders through four levels of
    # graph norms and attention, which the pair encoding's differences
    # raise (read: 7.4e-4 of logits up to 16.6, 8.7e-4 of affinities up
    # to 6.1); bf16 moves the affinities by ~0.2 at the median
    np.testing.assert_allclose(_host(a.logits, r), r['logits'], rtol=0,
                               atol=5e-4 * np.abs(r['logits']).max())
    np.testing.assert_allclose(a.edge_affinity, r['edge_affinity'], rtol=0,
                               atol=5e-4 * np.abs(r['edge_affinity']).max())


def test_the_partition_and_classes_meet_the_reference(served):
    _, host, a, r = served
    inst = np.unique(_host(a.instance, r), return_inverse=True)[1]
    assert _same_partition(inst, r['instance'])
    np.testing.assert_array_equal(_host(a.cls, r), r['cls'])
    # the port's solver on the reference's inputs: no worse than the
    # reference's greedy merge
    n1 = r['logits'].shape[0]
    port = tpan.instance_partition(
        host.levels[1].pos[:n1], r['logits'], r['edges'],
        r['edge_affinity'], node_size=host.levels[1].node_size[:n1],
        **SETTINGS)
    e = ref.energy(r['features'], r['node_weight'], r['edges'],
                   r['edge_weight'], SETTINGS['regularization'], port)
    e_ref = ref.energy(r['features'], r['node_weight'], r['edges'],
                       r['edge_weight'], SETTINGS['regularization'],
                       r['greedy'])
    assert e <= e_ref * (1 + 1e-9)


def _same_partition(a, b):
    a, b = np.asarray(a).tolist(), np.asarray(b).tolist()
    return len(set(zip(a, b))) == len(set(a)) == len(set(b))


def _clusters(seed, sizes):
    """A graph with one clear optimum: clusters of nodes that share a
    class and sit together, each joined inside by edges of affinity
    logit +6, the clusters joined by edges of -6."""
    rng = np.random.default_rng(seed)
    label = np.repeat(np.arange(len(sizes)), sizes)
    n = label.shape[0]
    pos = (label[:, None] * 5.0 + rng.normal(0, 0.05, (n, 3))).astype(
        np.float32)
    logits = np.full((n, 8), -4.0, np.float32)
    logits[np.arange(n), 2 + label] = 4.0
    u, v = np.triu_indices(n, 1)
    keep = (label[u] == label[v]) | (rng.random(u.shape[0]) < 0.3)
    edges = np.stack([u[keep], v[keep]])
    aff = np.where(label[u[keep]] == label[v[keep]], 6.0, -6.0).astype(
        np.float32)
    size = rng.integers(20, 200, n).astype(np.float32)
    return pos, logits, edges, aff, size, label


@pytest.mark.parametrize('seed,sizes', [(0, (3, 3)), (1, (2, 4, 2)),
                                        (2, (5, 1, 2)), (3, (1, 1, 6))])
def test_tiny_graphs_with_one_clear_optimum_partition_alike(seed, sizes):
    pos, logits, edges, aff, size, label = _clusters(seed, sizes)
    port = tpan.instance_partition(pos, logits, edges, aff, node_size=size,
                                   **SETTINGS)
    f, w, ew = ref.partition_inputs(pos, logits, aff, size,
                                    SETTINGS['x_weight'])
    greedy = ref.greedy_partition(f, w, edges, ew,
                                  SETTINGS['regularization'],
                                  SETTINGS['cutoff'])
    assert _same_partition(port, greedy) and _same_partition(port, label)


def test_the_stuff_merge_joins_the_stuff_components_of_a_tile():
    # tile 0: two separate class-0 pairs and a class-3 pair; tile 1: a
    # class-0 pair. Stuff classes 0 and 1.
    pos, logits, edges, aff, size, label = _clusters(4, (2, 2, 2, 2))
    logits[:] = -4.0
    logits[np.arange(8), [0, 0, 0, 0, 3, 3, 0, 0]] = 4.0
    graph = np.array([0, 0, 0, 0, 0, 0, 1, 1])
    port = tpan.instance_partition(pos, logits, edges, aff, node_size=size,
                                   stuff_classes=STUFF, batch=graph,
                                   **SETTINGS)
    assert _same_partition(port, [0, 0, 0, 0, 1, 1, 2, 2])
    f, w, ew = ref.partition_inputs(pos, logits, aff, size,
                                    SETTINGS['x_weight'])
    greedy = ref.greedy_partition(f, w, edges, ew,
                                  SETTINGS['regularization'],
                                  SETTINGS['cutoff'])
    assert _same_partition(greedy, label)
    assert _same_partition(port, ref.stuff_merge(greedy, logits, graph,
                                                 STUFF))


def test_strip_for_inference_drops_the_instance_targets(served):
    _, host, _, _ = served
    lvl = host.levels[1]
    lvl.obj_edge_affinity = np.ones(lvl.obj_edge_index.shape[1], np.float32)
    lvl.obj_pos = np.zeros((lvl.pos.shape[0], 3), np.float32)
    try:
        out = strip_for_inference(host).levels[1]
        assert out.obj_edge_affinity is None
        assert not hasattr(out, 'obj_pos')
        assert out.obj_edge_index is lvl.obj_edge_index
        assert out.obj_edge_mask is lvl.obj_edge_mask
        dev = from_numpy(host, 'cpu')[1]
        assert dev.obj_edge_affinity is None
        assert dev.obj_edge_index.dtype == torch.int64
        assert from_numpy(host, 'cpu', train=True)[1] \
            .obj_edge_affinity is not None
    finally:
        del lvl.obj_edge_affinity, lvl.obj_pos


def test_spans_and_counters_of_the_head_and_the_partition(served):
    task, host, _, r = served
    assert profiling.annotate('spt.partition') is profiling._OFF
    before = {k: getattr(tpan.instance_partition, k)
              for k in ('calls', 'nodes', 'edges', 'instances')}
    batch = from_numpy(host, 'cpu')
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        a = infer_panoptic_batch(task, batch, host, SETTINGS)
    spans = {}
    for e in prof.events():
        if e.name.startswith('spt.'):
            spans.setdefault(e.name, []).append(
                (e.time_range.start, e.time_range.end))
    for name in ('spt.forward', 'spt.affinity', 'spt.gather', 'spt.fetch',
                 'spt.partition'):
        assert name in spans, name
    (a0, a1), = spans['spt.affinity']
    (f0, f1), = spans['spt.forward']
    assert f0 <= a0 and a1 <= f1
    assert sum(a0 <= s and e <= a1 for s, e in spans['spt.gather']) == 2
    (p0, _), = spans['spt.partition']
    assert p0 >= f1
    got = {k: getattr(tpan.instance_partition, k) - v
           for k, v in before.items()}
    assert got == {'calls': 1, 'nodes': r['logits'].shape[0],
                   'edges': r['edges'].shape[1],
                   'instances': int(a.instance.max()) + 1}


@pytest.mark.parametrize('num_classes', [8, 13])
def test_instance_classes_are_the_per_instance_loop_bit_for_bit(
        num_classes):
    """`instance_classes` gives `trainer.validate_panoptic` the classes
    and scores that its loop over instances gave (float32 logits summed
    in row order), so PQ and mAP do not move."""
    rng = np.random.default_rng(num_classes)
    logits = (rng.standard_normal((2000, num_classes)) * 20).astype(
        np.float32)
    obj = np.unique(rng.integers(0, 300, 2000), return_inverse=True)[1]
    cls, score = tpan.instance_classes(obj, logits)
    for i in range(int(obj.max()) + 1):
        s = logits[obj == i].sum(0)
        p = np.exp(s - s.max())
        assert cls[i] == s.argmax() and score[i] == (p / p.sum()).max()
