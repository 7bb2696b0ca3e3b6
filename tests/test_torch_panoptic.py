"""SuperCluster panoptic segmentation in the port against the JAX package
on the CPU: `InstanceData` and the instance ops, preprocessing with
instance ids, the instance graph of `prepare_batch`, the instance
partition and its grid search, PQ and mAP, a narrow `PanopticTask`
(evaluation, loss, edge weights, 3 train steps in f32 and bf16) with
weights carried from JAX, `validate_panoptic`, the NAG files with
instances, `PANOPTIC_CFG` and `build_task`.

The host code is the same numpy code over the same native sources on
both sides, so its results must be bit-equal (integers, bools and floats
alike); the metrics are held to 1e-12. The model's tolerances are those
of tests/test_torch_train.py, stated there and below. On the CPU the
JAX model takes its XLA attention path; the port runs K1's and K2's
plain versions.
"""
import numpy as np
import pytest
import torch

import jax

from superpoint_transformer_tpu import trainer as jtrainer
from superpoint_transformer_tpu.data import Data as JData
from superpoint_transformer_tpu.data.csr import InstanceData as JInst
from superpoint_transformer_tpu.metrics import mean_average_precision as jmap
from superpoint_transformer_tpu.metrics import panoptic as jpq
from superpoint_transformer_tpu.models import panoptic as jpan
from superpoint_transformer_tpu.models.semantic import TrainState
from superpoint_transformer_tpu.models.spt import SPT as JSPT
from superpoint_transformer_tpu.ops import instance as jops
from superpoint_transformer_tpu.optim.lr_scheduler import (
    _is_transformer_param, make_optimizer)
from superpoint_transformer_tpu.transforms import instance as jtinst
from superpoint_transformer_tpu.transforms import prepare as jprep
from superpoint_transformer_tpu.transforms import preprocess as jpre
from superpoint_transformer_tpu.utils import synthetic as jsyn
from superpoint_transformer_torch import trainer as ttrainer
from superpoint_transformer_torch.data.csr import InstanceData as TInst
from superpoint_transformer_torch.data.data import Data as TData
from superpoint_transformer_torch.data.nag import NAG as TNAG
from superpoint_transformer_torch.data.padded import from_numpy
from superpoint_transformer_torch.experiment import (
    FLAGSHIP_CFG, PANOPTIC_CFG, build_model, build_task)
from superpoint_transformer_torch.metrics import (
    mean_average_precision as tmap)
from superpoint_transformer_torch.metrics import panoptic as tpq
from superpoint_transformer_torch.models import panoptic as tpan
from superpoint_transformer_torch.models.partition import PartitionTask
from superpoint_transformer_torch.models.spt import SPT as TSPT
from superpoint_transformer_torch.ops import instance as tops
from superpoint_transformer_torch.transforms import instance as ttinst
from superpoint_transformer_torch.transforms import prepare as tprep
from superpoint_transformer_torch.transforms import preprocess as tpre
from superpoint_transformer_torch.utils import synthetic as tsyn
from superpoint_transformer_torch.utils.jax_params import (jax_key_for,
                                                           load_jax_params)
from test_preprocess import synthetic_scene
from test_torch_host_path import (PRE, assert_arrays_equal,
                                  assert_nags_equal, assert_padded_equal)
from test_torch_train import (BF16_RATIO, HPARAMS, NARROW, STEPS,
                              TOL_F32, _flat, _mean_rel, _params,
                              _rel_l2, _updates)

NUM_CLASSES = 13
# a room of the host-path tests, small enough for the CPU
ROOM_POINTS = 20_000
# the metrics: the same numpy code on both sides, float64 sums
METRIC_TOL = 1e-12
# one bf16 rounding step, relative: the floor of the bf16 loss check
BF16_LOSS_FLOOR = 2.0 ** -8
# non-trivial case weights, so that the 4-case edge weighting is checked
EDGE_WEIGHTS = (1., 2., 3., 4.)
# the narrow task's batches hold 2 graphs (NARROW's num_graphs)
CFG = dict(instance=True)


def _instances(raw):
    """The tests/test_panoptic.py recipe: two objects per class, split
    at every metre of x."""
    return (raw.y * 2 + (raw.pos[:, 0] % 2 < 1)).astype(np.int64)


def _random_instance_data(cls, seed, n=60, n_obj=25, num_classes=5):
    """`cls` InstanceData over n clusters (some with no overlap), each
    overlapping 0-3 distinct objects; an object's label is its own, and
    label `num_classes` is void."""
    rng = np.random.default_rng(seed)
    sizes = rng.integers(0, 4, n)
    ptr = np.concatenate([[0], np.cumsum(sizes)]).astype(np.int64)
    obj = np.concatenate([rng.choice(n_obj, s, replace=False)
                          for s in sizes]).astype(np.int64)
    count = rng.integers(1, 100, obj.shape[0]).astype(np.int64)
    y_of_obj = rng.integers(0, num_classes + 1, n_obj)
    return cls(ptr, obj, count, y_of_obj[obj].astype(np.int64))


def _assert_same(name, got, ref):
    """Bit-equal numpy results, through tuples and InstanceData."""
    if isinstance(ref, (tuple, list)):
        assert len(got) == len(ref), name
        for i, (a, b) in enumerate(zip(got, ref)):
            _assert_same(f'{name}[{i}]', a, b)
    elif isinstance(ref, JInst):
        assert isinstance(got, TInst), name
        assert_arrays_equal(f'{name} pointers', got.pointers, ref.pointers,
                            0)
        for j, (a, b) in enumerate(zip(got.values, ref.values)):
            assert_arrays_equal(f'{name} values[{j}]', a, b, 0)
        for attr in ('pair_cropped_count',):
            assert hasattr(got, attr) == hasattr(ref, attr), (name, attr)
            if hasattr(ref, attr):
                assert_arrays_equal(f'{name} {attr}', getattr(got, attr),
                                    getattr(ref, attr), 0)
    else:
        assert_arrays_equal(name, got, ref, 0)


def _op_cases():
    def merge(cls, ops, seed):
        inst = _random_instance_data(cls, seed)
        idx = np.random.default_rng(seed + 100).integers(0, 20, 60)
        return inst.merge(idx)

    def cat(cls, ops, seed):
        return cls.cat([_random_instance_data(cls, seed + i)
                        for i in range(3)])

    def getitem(cls, ops, seed):
        inst = _random_instance_data(cls, seed)
        return inst[np.random.default_rng(seed).permutation(60)[:40]]

    def major(cls, ops, seed):
        inst = _random_instance_data(cls, seed)
        return ops.instance_major(inst), inst.major(num_classes=5)

    def iou_and_size(cls, ops, seed):
        inst = _random_instance_data(cls, seed)
        return inst.iou_and_size(), ops.instance_iou_and_size(inst)

    def search_void(cls, ops, seed):
        return _random_instance_data(cls, seed).search_void(5)

    def remove_void(cls, ops, seed):
        out, keep = _random_instance_data(cls, seed).remove_void(5)
        # the IoUs after the removal add the cropped void parts
        return out, keep, out.iou_and_size()

    def estimate_centroid(cls, ops, seed):
        inst = _random_instance_data(cls, seed)
        pos = np.random.default_rng(seed).normal(size=(60, 3)).astype(
            np.float32)
        return inst.estimate_centroid(pos), ops.estimate_instance_centroid(
            inst, pos, mode='ratio-product')

    def instance_graph(cls, ops, seed):
        inst = _random_instance_data(cls, seed)
        ei = np.random.default_rng(seed).integers(0, 60, (2, 300))
        return (inst.instance_graph(ei, num_classes=5),
                inst.instance_graph(ei, num_classes=5,
                                    smooth_affinity=False),
                ops.instance_graph_affinity(inst, ei))

    return {f.__name__: f for f in (
        merge, cat, getitem, major, iou_and_size, search_void, remove_void,
        estimate_centroid, instance_graph)}


OPS = _op_cases()


@pytest.mark.parametrize('op', sorted(OPS))
def test_instance_data_ops_match_jax(op):
    for seed in range(3):
        _assert_same(f'{op} seed {seed}', OPS[op](TInst, tops, seed),
                     OPS[op](JInst, jops, seed))


# ---- preprocessing, the instance graph and the batch ------------------

def _room_pair(seed):
    """(JAX NAG, port NAG) of one small synthetic room with instance ids,
    preprocessed by each package with the host-path tests' settings."""
    raws = []
    for syn in (jsyn, tsyn):
        raw = syn.synthetic_room_cloud(seed=seed, n_points=ROOM_POINTS)
        raw['obj'] = _instances(raw)
        raws.append(raw)
    return (jpre.preprocess_cloud(raws[0], with_instances=True, **PRE),
            tpre.preprocess_cloud(raws[1], with_instances=True, **PRE))


@pytest.fixture(scope='module')
def rooms():
    """Two rooms, seeds 0 and 1: [(JAX NAG, port NAG), ...]."""
    return [_room_pair(seed) for seed in (0, 1)]


def _scene_pair():
    """The scene and the settings of tests/test_panoptic.py's training
    test, through each package."""
    ref = synthetic_scene()
    out = []
    for pre, data_cls in ((jpre, JData), (tpre, TData)):
        data = data_cls(pos=ref.pos.copy(), rgb=ref.rgb.copy(),
                        y=ref.y.copy())
        data['obj'] = _instances(data)
        out.append(pre.preprocess_cloud(
            data, voxel=0.1, knn=12, knn_r=1.0, num_classes=3,
            pcp_regularization=(0.05, 0.2), pcp_spatial_weight=(2.0, 0.5),
            pcp_cutoff=(5, 5), graph_gap=(0.5, 1.0), with_instances=True))
    return out


@pytest.mark.parametrize('source', ['scene', 'room'])
def test_preprocess_with_instances_matches_jax(rooms, source):
    ref, got = _scene_pair() if source == 'scene' else rooms[0]
    for i in ref.levels:
        assert isinstance(got[i].get('obj'), TInst), i
        assert got[i].obj.num_groups == got[i].num_nodes
    # every key of every level, obj included, bit-equal
    assert_nags_equal(got, ref, 0)


@pytest.mark.parametrize('mode', ['available', 'radius-centroid',
                                  'radius-atomic'])
def test_instance_graph_matches_jax(rooms, mode):
    ref_nag, got_nag = rooms[0]
    kw = dict(level=1, num_classes=NUM_CLASSES, k_max=30,
              radius=0.1 if mode == 'radius-atomic' else 1.0,
              adjacency_mode=mode)
    ref = jtinst.on_the_fly_instance_graph(ref_nag.clone(), **kw)[1]
    got = ttinst.on_the_fly_instance_graph(got_nag.clone(), **kw)[1]
    assert got['obj_edge_index'].shape[1] > 0
    for k in ('obj_edge_index', 'obj_edge_affinity', 'obj_pos'):
        assert_arrays_equal(k, got[k], ref[k], 0)


def _prepare(mod, nags, train, seed=0):
    kw = {} if mod is tprep else {'device': False}
    return mod.prepare_batch(nags, mod.BatchConfig(**CFG), train=train,
                             rng=np.random.default_rng(seed), **kw)


@pytest.mark.parametrize('train', [False, True], ids=['eval', 'train'])
def test_prepare_batch_instance_matches_jax(rooms, train):
    ref = _prepare(jprep, [r[0] for r in rooms], train)
    got = _prepare(tprep, [r[1] for r in rooms], train)
    lvl = got.levels[1]
    assert lvl.obj_edge_index is not None and lvl.obj_edge_mask.any()
    assert lvl.obj_edge_affinity is not None
    # every field of every level, the obj edges included
    assert_padded_equal(got, ref, rtol=0)
    # on a device: obj edges as int64, the mask bool, affinities f32
    dev = from_numpy(got, 'cpu', 'bfloat16', train=True)[1]
    assert dev.obj_edge_index.dtype == torch.int64
    assert dev.obj_edge_mask.dtype == torch.bool
    assert dev.obj_edge_affinity.dtype == torch.float32
    assert dev.y is not None


def test_training_sampling_carries_obj(rooms):
    """The runtime sampling keeps `obj` InstanceData with its nodes: after
    `process_batch(train=True)` level 1's obj has one group per node."""
    big = tprep.process_batch([r[1] for r in rooms],
                              tprep.BatchConfig(**CFG), train=True,
                              rng=np.random.default_rng(0))
    ref = jprep.process_batch([r[0] for r in rooms],
                              jprep.BatchConfig(**CFG), train=True,
                              rng=np.random.default_rng(0))
    for k in ('obj_edge_index', 'obj_edge_affinity'):
        assert_arrays_equal(k, big[1][k], ref[1][k], 0)
    for r in rooms:
        assert r[1][1].obj.num_groups == r[1][1].num_nodes


# ---- the partition and the metrics -------------------------------------

def _oracle_inputs(nag, seed=0, noise=1.0):
    """Level-1 inputs of the partition from ground truth plus noise: the
    logits of each node's majority label, the affinities of the instance
    graph's targets."""
    nag = jtinst.on_the_fly_instance_graph(
        nag.clone(), level=1, num_classes=NUM_CLASSES, k_max=30,
        radius=0.1, adjacency_mode='radius-atomic')
    d = nag[1]
    rng = np.random.default_rng(seed)
    n = d.num_nodes
    y = np.asarray(d.y)[:, :NUM_CLASSES].argmax(1)
    logits = rng.normal(0, noise, (n, NUM_CLASSES)).astype(np.float32)
    logits[np.arange(n), y] += 3.0
    aff = (d.obj_edge_affinity * 8 - 4 + rng.normal(
        0, noise, d.obj_edge_affinity.shape)).astype(np.float32)
    return dict(pos=d.pos, node_logits=logits, edge_index=d.obj_edge_index,
                edge_affinity_logits=aff,
                node_size=np.asarray(d.node_size, np.float32)), d.obj


@pytest.mark.parametrize('stuff', [(), (0, 1, 2)], ids=['things', 'stuff'])
def test_instance_partition_matches_jax(rooms, stuff):
    inputs, _ = _oracle_inputs(rooms[0][0])
    batch = (np.arange(inputs['pos'].shape[0]) % 2).astype(np.int64)
    for settings in (dict(), dict(regularization=50., x_weight=1e-2,
                                  cutoff=100)):
        kw = dict(inputs, stuff_classes=stuff, num_classes=NUM_CLASSES,
                  batch=batch, **settings)
        got = tpan.instance_partition(**kw)
        ref = jpan.instance_partition(**kw)
        assert got.max() > 0
        assert_arrays_equal('obj_index', got, ref, 0)


def _assert_metrics_equal(got, ref):
    assert sorted(got) == sorted(ref)
    for k in ref:
        a, b = np.asarray(got[k], np.float64), np.asarray(ref[k],
                                                          np.float64)
        np.testing.assert_allclose(a, b, rtol=METRIC_TOL, atol=METRIC_TOL,
                                   equal_nan=True, err_msg=k)


@pytest.mark.parametrize('stuff', [(), (0, 1, 2)], ids=['things', 'stuff'])
def test_grid_search_matches_jax(rooms, stuff):
    inputs, _ = _oracle_inputs(rooms[0][0])
    obj_t = rooms[0][1][1].obj
    obj_j = rooms[0][0][1].obj
    args = [inputs[k] for k in ('pos', 'node_logits', 'edge_index',
                                'edge_affinity_logits')]
    kw = dict(node_size=inputs['node_size'], stuff_classes=stuff)
    got = tpan.grid_search_panoptic_partition(*args, obj_t, NUM_CLASSES,
                                              **kw)
    ref = jpan.grid_search_panoptic_partition(*args, obj_j, NUM_CLASSES,
                                              **kw)
    assert got[0] == ref[0]
    _assert_metrics_equal(got[1], ref[1])
    assert_arrays_equal('obj_index', got[2], ref[2], 0)
    assert got[1]['pq'] > 0


@pytest.mark.parametrize('stuff', [(), (0, 1, 2)], ids=['things', 'stuff'])
def test_pq_and_map_match_jax(rooms, stuff):
    """PanopticQuality3D and MeanAveragePrecision3D over two scenes (the
    oracle partitions of both rooms), with void objects: to 1e-12."""
    pq_t = tpq.PanopticQuality3D(NUM_CLASSES, stuff_classes=stuff)
    pq_j = jpq.PanopticQuality3D(NUM_CLASSES, stuff_classes=stuff)
    ap_t = tmap.MeanAveragePrecision3D(NUM_CLASSES, stuff_classes=stuff)
    ap_j = jmap.MeanAveragePrecision3D(NUM_CLASSES, stuff_classes=stuff)
    for i, (jn, tn) in enumerate(rooms):
        inputs, _ = _oracle_inputs(jn, seed=i, noise=2.0)
        obj_index = jpan.instance_partition(**inputs)
        logits = inputs['node_logits']
        merged_j = jn[1].obj.merge(obj_index)
        merged_t = tn[1].obj.merge(obj_index)
        # one void object in each scene: label NUM_CLASSES
        for m in (merged_j, merged_t):
            m.values[2] = np.where(m.obj == m.obj.min(), NUM_CLASSES,
                                   m.y)
        n_inst = int(obj_index.max()) + 1
        acc = np.zeros((n_inst, NUM_CLASSES))
        np.add.at(acc, obj_index, logits)
        sem = acc.argmax(1)
        score = np.random.default_rng(i).random(n_inst)
        pq_t.update_from_instance_data(merged_t, sem)
        pq_j.update_from_instance_data(merged_j, sem)
        ap_t.update_from_instance_data(merged_t, sem, score)
        ap_j.update_from_instance_data(merged_j, sem, score)
    got, ref = pq_t.compute(), pq_j.compute()
    assert 0 < got['pq'] <= 100
    _assert_metrics_equal(got, ref)
    _assert_metrics_equal(ap_t.compute(), ap_j.compute())
    # and the per-overlap entry point
    a = tpq.panoptic_quality_from_overlaps(
        [0, 1, 1, 2], [0, 0, 1, 2], [5, 1, 4, 3], [0, 1, 2],
        [0, 1, NUM_CLASSES], NUM_CLASSES, stuff_classes=stuff)
    b = jpq.panoptic_quality_from_overlaps(
        [0, 1, 1, 2], [0, 0, 1, 2], [5, 1, 4, 3], [0, 1, 2],
        [0, 1, NUM_CLASSES], NUM_CLASSES, stuff_classes=stuff)
    _assert_metrics_equal(a, b)
    scores, is_tp = np.array([.9, .8, .3, .5]), np.array([1, 0, 1, 1],
                                                          bool)
    assert tmap.average_precision(scores, is_tp, 5, np.linspace(0, 1, 101)) \
        == jmap.average_precision(scores, is_tp, 5, np.linspace(0, 1, 101))


# ---- the narrow PanopticTask --------------------------------------------

@pytest.fixture(scope='module')
def pan_batch(rooms):
    """The 2-room evaluation batch of the JAX host path, with the
    instance graph and the label histograms."""
    return _prepare(jprep, [r[0] for r in rooms], train=False)


def _jax_task(compute_dtype):
    return jpan.PanopticTask(
        net=JSPT(compute_dtype=compute_dtype, **NARROW),
        num_classes=NUM_CLASSES, edge_affinity_loss_weights=EDGE_WEIGHTS,
        **HPARAMS)


def _port_task(compute_dtype):
    return tpan.PanopticTask(
        TSPT(compute_dtype=compute_dtype, **NARROW),
        num_classes=NUM_CLASSES, edge_affinity_loss_weights=EDGE_WEIGHTS,
        **HPARAMS)


def _jax_run(batch, compute_dtype):
    task = _jax_task(compute_dtype)
    params = _params(task.model, batch)
    rng = jax.random.PRNGKey(0)
    loss, grads = jax.jit(jax.value_and_grad(
        lambda p: task._loss_fn(p, batch, rng)[0]))(params)
    lvl1 = batch[1]
    weights = np.asarray(task._edge_weights(batch,
                                            lvl1.obj_edge_affinity))
    params = jax.tree_util.tree_map(np.array, params)
    state = TrainState.create(
        apply_fn=task.model.apply, params=params,
        tx=make_optimizer(lr=task.lr, weight_decay=task.weight_decay,
                          transformer_lr_scale=task.transformer_lr_scale,
                          total_steps=task.total_steps,
                          num_warmup_steps=task.warmup_steps,
                          params=params))
    ev = {k: np.asarray(v) for k, v in task.eval_step(state, batch).items()}
    losses = []
    for _ in range(STEPS):
        state, metrics = task.train_step(state, batch, rng)
        losses.append(float(metrics['loss']))
    return dict(params=params, loss=float(loss), grads=_flat(grads),
                weights=weights, eval=ev, losses=losses,
                final=_flat(state.params))


@pytest.fixture(scope='module')
def jax_runs(pan_batch):
    return {cd: _jax_run(pan_batch, cd) for cd in (None, 'bfloat16')}


def _port_run(batch, compute_dtype, params):
    task = _port_task(compute_dtype)
    load_jax_params(task.model, params)
    tb = from_numpy(batch, 'cpu', compute_dtype, train=True)
    # the edge-affinity head trains at the base LR, as JAX labels it
    groups = {id(p): g['name'] for g in task.optimizer.param_groups
              for p in g['params']}
    labels = {jax_key_for(tuple(q.key for q in path)):
              _is_transformer_param(path) for path, _ in
              jax.tree_util.tree_leaves_with_path(params)}
    named = dict(task.model.named_parameters())
    assert set(named) == set(labels)
    assert any(k.startswith('edge_affinity_head.') for k in named)
    for key, p in named.items():
        assert (groups[id(p)] == 'transformer') == labels[key], key
    task.model.train()
    loss, _ = task.loss(tb)
    loss.backward()
    grads = {k: p.grad.numpy().copy() for k, p in named.items()}
    weights = task._edge_weights(tb, tb[1].obj_edge_affinity).numpy()
    ev = {k: v.numpy() for k, v in task.eval_step(tb).items()}
    losses = [task.train_step(tb)['loss'].item() for _ in range(STEPS)]
    return dict(loss=loss.item(), grads=grads, weights=weights, eval=ev,
                losses=losses,
                final={k: p.detach().numpy() for k, p in named.items()})


def test_panoptic_task_matches_jax_f32(pan_batch, jax_runs):
    ref = jax_runs[None]
    got = _port_run(pan_batch, None, ref['params'])
    # the 4-case edge weights: the same labels and cases, exactly
    np.testing.assert_array_equal(got['weights'], ref['weights'])
    assert len(np.unique(got['weights'])) >= 3
    np.testing.assert_allclose(got['loss'], ref['loss'],
                               rtol=TOL_F32['loss'])
    np.testing.assert_allclose(got['losses'], ref['losses'],
                               rtol=TOL_F32['loss'])
    for key, g in ref['grads'].items():
        scale = max(float(np.abs(g).max()), 1e-6)
        err = float(np.abs(got['grads'][key] - g).max())
        assert err <= TOL_F32['rel'] * scale, \
            f'{key}: gradient max err {err:.3e} vs |ref| {scale:.3e}'
    start = _flat(ref['params'])
    upd, ref_upd = _updates(got, start), _updates(ref, start)
    for key in start:
        assert np.abs(ref_upd[key]).max() > 0, key
        err = _rel_l2(upd[key], ref_upd[key])
        assert err <= TOL_F32['update'], f'{key}: update L2 err {err:.3e}'

    # eval_step at the initial parameters: the level-1 logits of the
    # valid nodes and the edge-affinity logits of every padded edge,
    # within 1e-4 of each tensor's largest entry
    ev, ref_ev = got['eval'], ref['eval']
    np.testing.assert_allclose(ev['loss'], ref_ev['loss'],
                               rtol=TOL_F32['loss'])
    valid = np.asarray(pan_batch.levels[1].node_mask)
    for key, rows in (('logits_level1', valid),
                      ('edge_affinity_logits', slice(None))):
        a, b = ev[key][rows], ref_ev[key][rows]
        assert a.shape == b.shape, key
        err, scale = np.abs(a - b).max(), np.abs(b).max()
        assert err <= TOL_F32['rel'] * scale, \
            f'{key}: {err:.3e} of {scale:.3e}'


def test_panoptic_task_matches_jax_bf16(pan_batch, jax_runs):
    """The port in bf16 is held to JAX's f32 as closely as JAX's bf16 is,
    within BF16_RATIO (tests/test_torch_train.py says why), plus, for the
    losses, one bf16 rounding step of the loss (BF16_LOSS_FLOOR): a
    scalar near 160 whose distance from the f32 loss is a few bf16
    roundings on either side. Over 2 room pairs and 4 weight draws
    (tests/bf16_loss_sweep.py), the bf16 loss of JAX jitted, JAX eager
    and the port, semantic and panoptic alike, lands on either side of
    the f32 loss, 0.005-0.26 from it (mean 0.07-0.12 for each run); on
    one draw JAX eager lands 4.3x as far as JAX jitted. So the ratio by
    itself holds the loss to the luck of one draw."""
    f32, jb = jax_runs[None], jax_runs['bfloat16']
    got = _port_run(pan_batch, 'bfloat16', jb['params'])
    start = _flat(f32['params'])
    pairs = {
        'loss': (abs(got['loss'] - f32['loss']),
                 abs(jb['loss'] - f32['loss'])),
        'losses': (np.abs(np.subtract(got['losses'], f32['losses'])).mean(),
                   np.abs(np.subtract(jb['losses'], f32['losses'])).mean()),
        'grads': (_mean_rel(got['grads'], f32['grads']),
                  _mean_rel(jb['grads'], f32['grads'])),
        'updates': (_mean_rel(_updates(got, start), _updates(f32, start)),
                    _mean_rel(_updates(jb, start), _updates(f32, start))),
    }
    floor = BF16_LOSS_FLOOR * abs(f32['loss'])
    for name, (port, jax_bf16) in pairs.items():
        print(f'{name}: port bf16 {port:.4g}, JAX bf16 {jax_bf16:.4g} '
              'from JAX f32')
        assert port <= BF16_RATIO * jax_bf16 + (
            floor if name in ('loss', 'losses') else 0.0), name
    assert np.isfinite(got['eval']['edge_affinity_logits']).all()


def test_weighted_bce_matches_jax():
    rng = np.random.default_rng(0)
    logits = rng.normal(0, 3, 200).astype(np.float32)
    target = rng.random(200).astype(np.float32)
    weight = rng.random(200).astype(np.float32)
    mask = rng.random(200) < 0.8
    import jax.numpy as jnp
    for w in (None, weight):
        ref = jpan._weighted_bce_with_logits(
            jnp.asarray(logits), jnp.asarray(target),
            None if w is None else jnp.asarray(w), jnp.asarray(mask))
        got = tpan._weighted_bce_with_logits(
            torch.from_numpy(logits), torch.from_numpy(target),
            None if w is None else torch.from_numpy(w),
            torch.from_numpy(mask))
        np.testing.assert_allclose(got.item(), float(ref), rtol=1e-6)


class _Loader:
    def __init__(self, nags):
        self.nags = nags

    def __iter__(self):
        for batch in self.nags:
            yield [n.clone() for n in batch]


def test_validate_panoptic_matches_jax(rooms, jax_runs):
    """Two batches of the two rooms, the grid search on the first: the
    same settings, instance count, PQ and mAP as the JAX validation with
    the same weights (the partition on logits within 1e-5 of each other
    takes the same merges here)."""
    params = jax_runs[None]['params']
    jtask = _jax_task(None)
    state = TrainState.create(apply_fn=jtask.model.apply, params=params,
                              tx=make_optimizer(params=params))
    ttask = _port_task(None)
    load_jax_params(ttask.model, params)
    order = [[r[0] for r in rooms], [r[0] for r in rooms[::-1]]]
    port_order = [[r[1] for r in rooms], [r[1] for r in rooms[::-1]]]
    ref = jtrainer.validate_panoptic(
        jtask, state, _Loader(order), jprep.BatchConfig(**CFG),
        num_classes=NUM_CLASSES, grid_search=True)
    got = ttrainer.validate_panoptic(
        ttask, _Loader(port_order), tprep.BatchConfig(**CFG),
        num_classes=NUM_CLASSES, grid_search=True)
    assert got['settings'] == ref['settings']
    assert got['n_pred_instances'] == ref['n_pred_instances']
    for k in ('pq', 'sq', 'rq', 'pq_modified', 'map', 'map_50', 'map_25',
              'map_mar', 'edge_affinity_acc', 'edge_affinity_gt_pos_frac'):
        np.testing.assert_allclose(got[k], ref[k], rtol=METRIC_TOL,
                                   atol=METRIC_TOL, equal_nan=True,
                                   err_msg=k)
    assert 0 <= got['pq'] <= 100


# ---- files, config and entry points ------------------------------------

def test_nag_files_with_instances_read_across_packages(rooms, tmp_path):
    pytest.importorskip('h5py')
    ref, got = rooms[0]
    path = tmp_path / 'room.h5'
    ref.save(path)
    loaded = TNAG.load(path)
    assert isinstance(loaded[1].obj, TInst)
    assert_nags_equal(loaded, type(ref).load(path), 0)
    back = tmp_path / 'room_port.h5'
    got.save(back)
    assert_nags_equal(TNAG.load(back), type(ref).load(back), 0)


def _leaves(tree, prefix=''):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _leaves(v, f'{prefix}.{k}' if prefix else k)
    else:
        yield prefix, tree


def test_panoptic_cfg_equals_yaml_composition():
    """PANOPTIC_CFG is the JAX loader's resolution of
    experiment=panoptic/s3dis on every key that build_model and
    build_task read."""
    import os
    from superpoint_transformer_tpu.config.loader import load_config
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    cfg = load_config(os.path.join(root, 'configs'), 'train',
                      ['experiment=panoptic/s3dis'])
    for path, value in _leaves(PANOPTIC_CFG):
        assert cfg.get_path(path) == value, path
    # the backbone is the flagship's
    a = build_model(PANOPTIC_CFG, num_graphs=2, device='cpu')
    b = build_model(FLAGSHIP_CFG, num_graphs=2, device='cpu')
    assert {k: v.shape for k, v in a.state_dict().items()} == \
        {k: v.shape for k, v in b.state_dict().items()}


def test_build_task_reads_the_panoptic_values():
    task = build_task(PANOPTIC_CFG, num_graphs=2, total_steps=1000,
                      device='cpu')
    assert isinstance(task, tpan.PanopticTask)
    assert task.edge_affinity_loss_lambda == 1.0
    assert task.edge_affinity_loss_weights == (1., 1., 1., 1.)
    assert task.stuff_classes == ()
    assert task.loss_type == 'ce_kl' and task.lambdas == (1.0, 50.0)
    head = task.model.edge_affinity_head
    assert head.linear_0.in_features == 2 * 64
    assert head.linear_0.out_features == 32 and head.linear_1.out_features == 1
    base, attn = task.optimizer.param_groups
    assert (base['name'], attn['name']) == ('base', 'transformer')
    assert all(any(p is q for q in base['params'])
               for p in head.parameters())
    assert base['weight_decay'] == 1e-2
    np.testing.assert_allclose([s(20) for s in task.schedules],
                               [0.1, 0.01], rtol=1e-12)
    # the flagship's parameters plus the head's
    n_sem = sum(p.numel() for p in build_task(
        FLAGSHIP_CFG, num_graphs=2, device='cpu').model.parameters())
    n_pan = sum(p.numel() for p in task.model.parameters())
    assert n_pan == n_sem + (128 * 32 + 32) + (32 + 1)


def test_build_task_panoptic_builds_on_the_card_unless_asked_for_the_cpu():
    if torch.cuda.is_available():
        task = build_task(PANOPTIC_CFG, num_graphs=2)
        assert all(p.is_cuda for p in task.model.parameters())
    else:
        with pytest.raises(RuntimeError, match='no CUDA device'):
            build_task(PANOPTIC_CFG, num_graphs=2)
    task = build_task(PANOPTIC_CFG, num_graphs=2, device='cpu')
    assert all(p.device.type == 'cpu' for p in task.model.parameters())
    # model.task 'partition' builds EZ-SP's stage-1 task over the point
    # features, with the partition model's keys
    part = build_task({**PANOPTIC_CFG, 'model': {
        **PANOPTIC_CFG['model'], 'task': 'partition', 'cnn_width': 16,
        'cnn_depth': 1, 'cnn_out': 8,
        'optimizer': {'lr': '1e-4', 'weight_decay': '1e-4'}}},
        num_graphs=2, device='cpu')
    assert isinstance(part, PartitionTask)
    assert part.model.cnn.channels == [16, 8]
    assert part.model.cnn.block_0.weight.shape == (16, 27 * 8)
    assert all(p.device.type == 'cpu' for p in part.model.parameters())


def test_random_nag_with_instances_matches_jax():
    assert_nags_equal(tsyn.random_nag(seed=3, with_instances=True),
                      jsyn.random_nag(seed=3, with_instances=True), 0)
