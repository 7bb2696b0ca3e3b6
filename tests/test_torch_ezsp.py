"""EZ-SP in the port against the JAX package on the CPU: the same numpy
inputs from seeds through both.

Bit-equal (host code, integers, the same numpy and native sources on both
sides): the sparse-convolution rulebook, the components helpers and the
label propagation, `quantize_coordinates`, the greedy contour-prior
partition in each edge-weight mode, `pad_point_cloud` /
`prepare_partition_batch`, the oracles and `partition_purity`,
`preprocess_cloud(partition_mode='contour_prior')` without a stage-1
checkpoint, and with one where both sides partition the same embeddings.

Within f32 tolerances (the same math in another summation order):
`SparseCNN` from the same weights (CNN_TOL), the partition criterion
(CRIT_TOL), a `PartitionTask` step and 3 steps (the tolerances of
tests/test_torch_train.py), 2 epochs of `fit_partition` (FIT_RTOL), and
the frozen CNN's embeddings in stage-2 preprocessing (CNN_TOL).
"""
import csv
import json
import os.path as osp

import numpy as np
import pytest
import torch

import jax

from superpoint_transformer_tpu import trainer as jtrainer
from superpoint_transformer_tpu.config.loader import load_config as jload
from superpoint_transformer_tpu.data import pad as jpad
from superpoint_transformer_tpu.data.csr import InstanceData as JInst
from superpoint_transformer_tpu.data.data import Data as JData
from superpoint_transformer_tpu.datasets.base import (
    BaseDataset as JBaseDataset)
from superpoint_transformer_tpu.experiment import (
    _pre_transform_config as jpre_cfg)
from superpoint_transformer_tpu.loss.partition_criterion import (
    partition_criterion as jcriterion)
from superpoint_transformer_tpu.metrics import oracle as joracle
from superpoint_transformer_tpu.models import partition as jpart
from superpoint_transformer_tpu.nn.sparse import SparseCNN as JSparseCNN
from superpoint_transformer_tpu.ops import components as jcomp
from superpoint_transformer_tpu.ops import voxel_conv as jvc
from superpoint_transformer_tpu.transforms import prepare as jprep
from superpoint_transformer_tpu.transforms import preprocess as jpre
from superpoint_transformer_tpu.utils import synthetic as jsyn
from superpoint_transformer_torch import experiment as texp
from superpoint_transformer_torch import train as ttrain
from superpoint_transformer_torch import trainer as ttrainer
from superpoint_transformer_torch.config import load_config as tload
from superpoint_transformer_torch.data import pad as tpad
from superpoint_transformer_torch.data.csr import InstanceData as TInst
from superpoint_transformer_torch.data.data import Data as TData
from superpoint_transformer_torch.data.padded import point_cloud_from_numpy
from superpoint_transformer_torch.datasets.base import (
    BaseDataset as TBaseDataset)
from superpoint_transformer_torch.loss import partition_criterion as tcrit
from superpoint_transformer_torch.metrics import oracle as toracle
from superpoint_transformer_torch.models import partition as tpart
from superpoint_transformer_torch.nn.sparse import SparseCNN as TSparseCNN
from superpoint_transformer_torch.ops import components as tcomp
from superpoint_transformer_torch.ops import voxel_conv as tvc
from superpoint_transformer_torch.transforms import prepare as tprep
from superpoint_transformer_torch.transforms import preprocess as tpre
from superpoint_transformer_torch.utils import synthetic as tsyn
from superpoint_transformer_torch.utils.ezsp_demo import run_ezsp_demo
from superpoint_transformer_torch.utils.jax_params import load_jax_params
from test_torch_host_path import (PRE, assert_arrays_equal,
                                  assert_nags_equal)
from test_torch_train import TOL_F32, _flat, _rel_l2
from test_torch_trainer import one_torch_thread  # noqa: F401

NUM_CLASSES = 13
# the narrow CNN: two blocks of 8 channels over the 8 S3DIS point features
CHANNELS = (8, 8)
# f32 activations of O(1) after each GraphNorm, the same products summed
# in another order (27 * 8 terms a product)
CNN_TOL = 1e-5
# the criterion's loss and affinities, from the same embeddings
CRIT_TOL = 1e-6
# per-epoch mean losses of 2 AdamW steps an epoch from the same weights
FIT_RTOL = 1e-4
# a peak LR that moves the weights visibly in 3 steps; no warm-up, as the
# partition task has none
TASK_HP = dict(lr=1e-3, weight_decay=1e-4, total_steps=10)
ROOM_POINTS = 8_000
# stage 2 at the JAX tests' small sizes
CONTOUR = dict(partition_mode='contour_prior',
               contour_prior_min_size=(5, 30, 90))
CFG = jprep.BatchConfig(num_classes=NUM_CLASSES)
TCFG = tprep.BatchConfig(num_classes=NUM_CLASSES)


def _nags(pkg, seeds=(0, 1), n_points=400):
    return [pkg.random_nag(seed=s, n_points=n_points) for s in seeds]


@pytest.fixture(scope='module')
def rooms():
    """One small synthetic room preprocessed by each package (cut
    pursuit): (JAX NAG, port NAG, port raw cloud)."""
    raw_j = jsyn.synthetic_room_cloud(seed=0, n_points=ROOM_POINTS)
    raw_t = tsyn.synthetic_room_cloud(seed=0, n_points=ROOM_POINTS)
    return (jpre.preprocess_cloud(raw_j.clone(), **PRE),
            tpre.preprocess_cloud(raw_t.clone(), **PRE), raw_t)


# -- host code, bit-equal --------------------------------------------------

@pytest.mark.parametrize('kernel_size,dilation,batched',
                         [(3, 1, False), (3, 1, True), (3, 2, True),
                          (5, 1, False)])
def test_sparse_conv_neighbors_match_jax(kernel_size, dilation, batched):
    rng = np.random.default_rng(kernel_size * 10 + dilation)
    coords = rng.integers(-6, 6, (600, 3))
    batch = rng.integers(0, 3, 600)
    # unique within a graph
    key = np.unique(np.concatenate([batch[:, None], coords], 1), axis=0)
    coords, batch = key[:, 1:], key[:, 0]
    b = batch if batched else None
    if not batched:
        coords = np.unique(coords, axis=0)
    kw = dict(kernel_size=kernel_size, dilation=dilation, batch=b)
    got = tvc.build_sparse_conv_neighbors(coords, **kw)
    ref = jvc.build_sparse_conv_neighbors(coords, **kw)
    assert_arrays_equal('nbr', got, ref, 0)
    assert got.dtype == np.int32
    center = (kernel_size ** 3) // 2
    np.testing.assert_array_equal(got[:, center], np.arange(len(coords)))
    if batched:
        rows, cols = np.nonzero(got >= 0)
        assert (batch[got[rows, cols]] == batch[rows]).all()
    assert_arrays_equal('offsets', tvc.kernel_offsets(kernel_size, dilation),
                        jvc.kernel_offsets(kernel_size, dilation), 0)


def _graph(seed, n=300, e=900):
    rng = np.random.default_rng(seed)
    ei = rng.integers(0, n, (2, e))
    w = rng.random(e).astype(np.float32) + 0.1
    return rng, n, ei, w


@pytest.mark.parametrize('reduce', ['add', 'mean', 'max', 'min', 'mul'])
def test_component_graph_matches_jax(reduce):
    rng, n, ei, w = _graph(1)
    sup = rng.integers(0, 40, n)
    got = tcomp.component_graph_np(sup, ei, w, reduce=reduce)
    ref = jcomp.component_graph_np(sup, ei, w, reduce=reduce)
    for name, a, b in zip(('edge_index', 'weight'), got, ref):
        assert_arrays_equal(name, a, b, 0)
    got = tcomp.component_graph_np(sup, ei, None, reduce=reduce,
                                   no_self_loops=False)
    ref = jcomp.component_graph_np(sup, ei, None, reduce=reduce,
                                   no_self_loops=False)
    for name, a, b in zip(('edge_index', 'weight'), got, ref):
        assert_arrays_equal(name, a, b, 0)


def test_consecutive_and_connect_isolated_match_jax():
    rng, n, ei, w = _graph(2)
    labels = rng.integers(0, 10_000, n)
    for a, b in zip(tcomp.consecutive_np(labels),
                    jcomp.consecutive_np(labels)):
        assert_arrays_equal('consecutive', a, b, 0)
    # a sparse graph leaves isolated nodes
    ei = ei[:, :60]
    pos = rng.random((n, 3)).astype(np.float32)
    for w_adj in (0.0, 1.0):
        got = tcomp.connect_isolated_knn_np(ei, w[:60], pos, 3, w_adj)
        ref = jcomp.connect_isolated_knn_np(ei, w[:60], pos, 3, w_adj)
        assert got[0].shape[1] > 60
        for name, a, b in zip(('edge_index', 'weight'), got, ref):
            assert_arrays_equal(name, a, b, 0)


@pytest.mark.parametrize('merge_only_small,k', [(False, 0), (False, 4),
                                                (True, 4)])
def test_merge_by_contour_prior_matches_jax(merge_only_small, k):
    rng, n, ei, w = _graph(3, e=500)
    x = rng.normal(size=(n, 4)).astype(np.float32)
    size = rng.integers(1, 9, n).astype(np.float32)
    pos = rng.random((n, 3)).astype(np.float32)
    kw = dict(merge_only_small=merge_only_small, pos=pos, k=k,
              w_adjacency=0.5)
    got = tcomp.merge_components_by_contour_prior_np(x, size, ei, w, 0.05,
                                                     6, **kw)
    ref = jcomp.merge_components_by_contour_prior_np(x, size, ei, w, 0.05,
                                                     6, **kw)
    assert got[1] == ref[1] and 1 < got[1] < n
    assert_arrays_equal('labels', got[0], ref[0], 0)
    for name, a, b in zip(('x', 'size', 'edge_index', 'weight', 'pos'),
                          got[2], ref[2]):
        assert_arrays_equal(name, a, b, 0)


def test_wcc_by_max_propagation_matches_numpy_twin_and_jax():
    """The torch propagation (with masked edges), its numpy wrapper and
    the JAX jitted propagation give the same components."""
    rng = np.random.default_rng(4)
    n = 500
    # chains (long paths: the pointer jumping) and random pairs
    chain = np.stack([np.arange(0, 199), np.arange(1, 200)])
    ei = np.concatenate([chain, rng.integers(200, n, (2, 150))], 1)
    # drop a tenth of the random pairs, none of the chain
    mask = rng.random(ei.shape[1]) > 0.1
    mask[:199] = True
    got = tcomp.wcc_by_max_propagation(n, torch.from_numpy(ei),
                                       torch.from_numpy(mask))
    ref = jcomp.wcc_by_max_propagation(n, jax.numpy.asarray(ei),
                                       jax.numpy.asarray(mask))
    assert got.dtype == torch.int32
    assert_arrays_equal('labels', got.numpy(), np.asarray(ref), 0)
    kept = ei[:, mask]
    for a, b in zip(tcomp.wcc_by_max_propagation_np(n, kept),
                    jcomp.wcc_by_max_propagation_np(n, kept)):
        assert_arrays_equal('components', a, b, 0)
    # the twin: the components of the unmasked edges, relabeled
    twin = tcomp.consecutive_np(got.numpy())[0]
    np.testing.assert_array_equal(
        twin, tcomp.wcc_by_max_propagation_np(n, kept)[0])
    assert twin[0] == twin[199]


def test_quantize_coordinates_matches_jax(rooms):
    pos = rooms[2].pos
    got = tpre.quantize_coordinates(TData(pos=pos), size=0.07)
    ref = jpre.quantize_coordinates(JData(pos=pos), size=0.07)
    assert_arrays_equal('coords', got.coords, ref.coords, 0)


def _level0(nag, cls):
    """A level-0 `cls` Data of `nag` with features, histograms and the
    adjacency of the partition: the input of the greedy partition."""
    d = nag[0]
    rng = np.random.default_rng(5)
    n = d.num_nodes
    src = np.repeat(np.arange(n), 4)
    dst = rng.integers(0, n, 4 * n)
    x = np.concatenate([d.rgb, d.linearity, d.planarity], 1)
    return cls(pos=np.asarray(d.pos, np.float32), x=x.astype(np.float32),
               y=np.asarray(d.y), edge_index=np.stack([src, dst]))


@pytest.mark.parametrize('mode', ['unit', 'inverse_distance',
                                  'exp_neg_distance',
                                  'exp_neg_latent_distance'])
def test_greedy_contour_prior_partition_matches_jax(rooms, mode):
    kw = dict(reg=[0.02, 0.05], min_size=[5, 20], edge_weight_mode=mode,
              k=3, spatial_weight=0.1 if mode == 'unit' else None)
    got = tpre.greedy_contour_prior_partition(_level0(rooms[1], TData),
                                              **kw)
    ref = jpre.greedy_contour_prior_partition(_level0(rooms[0], JData),
                                              **kw)
    assert_nags_equal(got, ref, 0)
    assert got[0].num_nodes > got[1].num_nodes > got[2].num_nodes > 1


def test_pad_point_cloud_matches_jax():
    """Label ids (one-hot) and histograms, graphs kept apart."""
    rng = np.random.default_rng(6)
    datas = []
    for j, n in enumerate((150, 90)):
        coords = np.unique(rng.integers(0, 8, (n, 3)), axis=0)
        n = coords.shape[0]
        datas.append(dict(pos=coords.astype(np.float32) * 0.1,
                          x=rng.random((n, 5)).astype(np.float32),
                          coords=coords,
                          edge_index=rng.integers(0, n, (2, 3 * n)),
                          y=rng.integers(-1, NUM_CLASSES + 2, n)))
    for hist in (False, True):
        ds = [dict(d, y=np.eye(NUM_CLASSES + 1)[np.clip(d['y'], 0,
                                                        NUM_CLASSES)])
              if hist else d for d in datas]
        got = tpad.pad_point_cloud([TData(**d) for d in ds],
                                   num_classes=NUM_CLASSES)
        ref = jpad.pad_point_cloud([JData(**d) for d in ds],
                                   num_classes=NUM_CLASSES)
        _assert_clouds_equal(got, ref)


def _assert_clouds_equal(got, ref):
    """Every field of a port `PaddedPointCloud` (numpy leaves) equal to
    the JAX one's."""
    assert got.num_nodes == int(ref.num_nodes)
    for f in ('pos', 'x', 'node_mask', 'batch', 'cnn_nbr_idx',
              'edge_index', 'edge_mask', 'y'):
        a, b = getattr(got, f), getattr(ref, f)
        assert (a is None) == (b is None), f
        if b is not None:
            assert_arrays_equal(f, a, np.asarray(b), 0)


@pytest.mark.parametrize('train', [False, True], ids=['eval', 'train'])
def test_prepare_partition_batch_matches_jax(rooms, train):
    """On preprocessed rooms (rgb over 1.5 rescaled), cropped in training
    with the same random draws."""
    tcfg = tprep.BatchConfig(num_classes=NUM_CLASSES, max_num_nodes=1_500)
    jcfg = jprep.BatchConfig(num_classes=NUM_CLASSES, max_num_nodes=1_500)
    got = tprep.prepare_partition_batch(
        [rooms[1], rooms[1]], tcfg, train=train,
        rng=np.random.default_rng(7))
    ref = jprep.prepare_partition_batch(
        [rooms[0], rooms[0]], jcfg, train=train,
        rng=np.random.default_rng(7))
    _assert_clouds_equal(got, ref)
    assert got.num_nodes == (3_000 if train else 2 * rooms[1][0].num_nodes)
    on = point_cloud_from_numpy(got, 'cpu')
    assert on.cnn_nbr_idx.dtype == torch.int64 and on.num_nodes == \
        got.num_nodes and on.y.dtype == torch.float32


def test_oracles_and_partition_purity_match_jax():
    rng = np.random.default_rng(8)
    y_hist = rng.integers(0, 5, (300, NUM_CLASSES + 1))
    sup = rng.integers(0, 40, 300)
    got = toracle.semantic_segmentation_oracle(y_hist, NUM_CLASSES)
    ref = joracle.semantic_segmentation_oracle(y_hist, NUM_CLASSES)
    assert_arrays_equal('confmat', got['confmat'], ref['confmat'], 0)
    for k in ('miou', 'oa', 'macc'):
        assert got[k] == ref[k], k
    assert_arrays_equal('purity', tpart.partition_purity(sup, y_hist, 13),
                        jpart.partition_purity(sup, y_hist, 13), 0)

    def inst(cls, seed):
        r = np.random.default_rng(seed)
        sizes = r.integers(1, 4, 50)
        ptr = np.concatenate([[0], np.cumsum(sizes)]).astype(np.int64)
        obj = np.concatenate([r.choice(20, s, replace=False)
                              for s in sizes]).astype(np.int64)
        y_of = r.integers(0, 6, 20)
        return cls(ptr, obj, r.integers(1, 50, obj.shape[0]).astype(
            np.int64), y_of[obj].astype(np.int64))

    for name in ('panoptic_segmentation_oracle',
                 'instance_segmentation_oracle'):
        got = getattr(toracle, name)(inst(TInst, 9), 5, stuff_classes=(4,))
        ref = getattr(joracle, name)(inst(JInst, 9), 5, stuff_classes=(4,))
        assert sorted(got) == sorted(ref), name
        for k, v in ref.items():
            np.testing.assert_allclose(np.asarray(got[k], np.float64),
                                       np.asarray(v, np.float64),
                                       rtol=1e-12, err_msg=f'{name} {k}')


# -- the model, the loss, the task: f32 tolerances -----------------------------

@pytest.fixture(scope='module')
def batches():
    """Two training batches of two random NAGs each (cropped to 300 voxels
    a graph with the same draws), numpy and JAX."""
    tcfg = tprep.BatchConfig(num_classes=NUM_CLASSES, max_num_nodes=300)
    jcfg = jprep.BatchConfig(num_classes=NUM_CLASSES, max_num_nodes=300)
    t_rng, j_rng = np.random.default_rng(0), np.random.default_rng(0)
    out = []
    for seeds in ((0, 1), (2, 3)):
        t = tprep.prepare_partition_batch(_nags(tsyn, seeds), tcfg,
                                          rng=t_rng, node_cap=640,
                                          edge_cap=8_192)
        j = jprep.prepare_partition_batch(_nags(jsyn, seeds), jcfg,
                                          rng=j_rng, node_cap=640,
                                          edge_cap=8_192)
        _assert_clouds_equal(t, j)
        out.append((t, j))
    return out


def _jax_task(**kw):
    return jpart.PartitionTask(
        net=jpart.PartitionModel(channels=CHANNELS, num_graphs=2),
        num_classes=NUM_CLASSES, **{**TASK_HP, **kw})


def _port_task(params, **kw):
    model = tpart.PartitionModel(8, channels=CHANNELS, num_graphs=2)
    load_jax_params(model, params)
    return tpart.PartitionTask(model, num_classes=NUM_CLASSES,
                               **{**TASK_HP, **kw})


def _jax_state(batches):
    return _jax_task().init_state(jax.random.PRNGKey(0), batches[0][1])


@pytest.fixture(scope='module')
def jax_params(batches):
    """The JAX task's initial parameters, as numpy (its train step
    donates the state's arrays)."""
    return jax.tree_util.tree_map(np.asarray, _jax_state(batches).params)


def test_sparse_cnn_matches_jax(batches, jax_params):
    """The narrow CNN from the JAX weights (`load_jax_params` maps
    `cnn/block_<i>/kernel` and `GraphNorm_0`), a last block without norm
    (a bias) too."""
    t, j = batches[0]
    tb = point_cloud_from_numpy(t, 'cpu')
    params = jax_params['cnn']
    for last_norm in (True, False):
        jm = JSparseCNN(channels=CHANNELS, num_graphs=2, last_norm=last_norm)
        p = params if last_norm else jm.init(
            jax.random.PRNGKey(1), j.x, j.cnn_nbr_idx, batch=j.batch,
            mask=j.node_mask)['params']
        ref = jm.apply({'params': p}, j.x, j.cnn_nbr_idx, batch=j.batch,
                       mask=j.node_mask)
        tm = TSparseCNN(8, CHANNELS, num_graphs=2, last_norm=last_norm)
        load_jax_params(tm, p)
        got = tm(tb.x, tb.cnn_nbr_idx, batch=tb.batch, mask=tb.node_mask)
        np.testing.assert_allclose(got.detach().numpy(), np.asarray(ref),
                                   rtol=CNN_TOL, atol=CNN_TOL)
    # the instance and layer norms build their flax-named submodule
    # (their parity with JAX: test_torch_point_cnn.py); an unknown norm
    # raises
    assert hasattr(TSparseCNN(8, CHANNELS, norm='instance').block_0,
                   'InstanceNorm_0')
    with pytest.raises(ValueError, match='unknown norm'):
        TSparseCNN(8, CHANNELS, norm='batch')


@pytest.mark.parametrize('case', ['train', 'eval', 'no_inter'])
def test_partition_criterion_matches_jax(batches, case):
    t, j = batches[0]
    tb = point_cloud_from_numpy(t, 'cpu')
    rng = np.random.default_rng(10)
    x = rng.normal(size=(t.capacity, 6)).astype(np.float32)
    y = np.asarray(t.y)
    if case == 'no_inter':
        # one label everywhere: no inter edge, a zero loss
        y = np.zeros_like(y)
        y[:, 2] = 1.0
    kw = dict(num_classes=NUM_CLASSES, affinity_temperature=0.7,
              gamma=2.0, train=case != 'eval')
    got, gaux = tcrit.partition_criterion(
        torch.from_numpy(x), torch.from_numpy(y), tb.edge_index,
        edge_mask=tb.edge_mask, **kw)
    ref, raux = jcriterion(
        jax.numpy.asarray(x), jax.numpy.asarray(y), j.edge_index,
        edge_mask=j.edge_mask, **kw)
    np.testing.assert_allclose(float(got), float(ref), rtol=CRIT_TOL)
    for k in ('n_inter_edge', 'n_valid_edge', 'target_affinity',
              'edge_valid'):
        assert_arrays_equal(k, gaux[k].numpy(), np.asarray(raux[k]), 0)
    np.testing.assert_allclose(gaux['predicted_affinity'].numpy(),
                               np.asarray(raux['predicted_affinity']),
                               rtol=CRIT_TOL, atol=CRIT_TOL)
    if case == 'no_inter':
        assert float(got) == 0.0 and int(gaux['n_inter_edge']) == 0
    else:
        assert int(gaux['n_inter_edge']) > 0


def test_partition_task_step_matches_jax(batches, jax_params):
    """One step's loss and gradients, its update, and 3 steps' losses."""
    jtask = _jax_task()
    jax_state = _jax_state(batches)
    task = _port_task(jax_params)
    start = {k: v.detach().clone().numpy()
             for k, v in task.model.state_dict().items()}
    (jloss, _), jgrads = jax.value_and_grad(jtask._loss_fn, has_aux=True)(
        jax_state.params, batches[0][1])
    tb = [point_cloud_from_numpy(t, 'cpu') for t, _ in batches]
    loss, _, _ = task.loss(tb[0])
    loss.backward()
    np.testing.assert_allclose(loss.item(), float(jloss),
                               rtol=TOL_F32['loss'])
    for k, ref in _flat({'cnn': jgrads['cnn']}).items():
        g = dict(task.model.named_parameters())[k].grad.numpy()
        scale = max(np.abs(ref).max(), 1e-12)
        assert np.abs(g - ref).max() / scale <= TOL_F32['rel'], k
    task.model.zero_grad()

    state, losses, jlosses = jax_state, [], []
    for s in range(3):
        b = s % 2
        state, jm = jtask.train_step(state, batches[b][1])
        m = task.train_step(tb[b])
        losses.append(float(m['loss']))
        jlosses.append(float(jm['loss']))
        assert int(m['n_inter_edge']) == int(jm['n_inter_edge'])
    np.testing.assert_allclose(losses, jlosses, rtol=TOL_F32['loss'])
    final = _flat(state.params)
    for k, v in task.model.state_dict().items():
        assert _rel_l2(v.numpy() - start[k], final[k] - start[k]) <= \
            TOL_F32['update'], k
    assert task.step == 3
    # eval_step: the loss without the reweighting, and the embeddings
    out = task.eval_step(tb[0])
    jout = jtask.eval_step(state, batches[0][1])
    np.testing.assert_allclose(float(out['loss']), float(jout['loss']),
                               rtol=TOL_F32['loss'])
    emb = task.embed(tb[0])
    assert emb.shape == (tb[0].num_nodes, CHANNELS[-1])


class _Loader:
    """Two batches an epoch of two NAGs each."""

    def __init__(self, pkg):
        self.nags = _nags(pkg, seeds=(0, 1, 2, 3))

    def __iter__(self):
        yield [n.clone() for n in self.nags[:2]]
        yield [n.clone() for n in self.nags[2:]]


@pytest.fixture(scope='module')
def fits(batches, jax_params, tmp_path_factory):
    """2 epochs of `fit_partition` in each package from the same weights,
    crops to 300 voxels a graph from the same seed."""
    jdir = str(tmp_path_factory.mktemp('fit_jax'))
    tdir = str(tmp_path_factory.mktemp('fit_port'))
    jcfg = jprep.BatchConfig(num_classes=NUM_CLASSES, max_num_nodes=300)
    tcfg = tprep.BatchConfig(num_classes=NUM_CLASSES, max_num_nodes=300)
    jtask = _jax_task()
    # the JAX loop initializes from PRNGKey(seed) on its first batch: the
    # same weights as `jax_params` (same key, same shapes)
    jstate = jtrainer.fit_partition(jtask, _Loader(jsyn), jcfg,
                                    output_dir=jdir, max_epochs=2)
    task = _port_task(jax_params)
    trainer = ttrainer.fit_partition(task, _Loader(tsyn), tcfg,
                                     output_dir=tdir, max_epochs=2)
    return jdir, tdir, jstate, trainer


def _csv(path):
    with open(path) as f:
        return list(csv.DictReader(f))


def test_fit_partition_matches_jax(fits):
    jdir, tdir, jstate, trainer = fits
    got, ref = _csv(osp.join(tdir, 'metrics.csv')), \
        _csv(osp.join(jdir, 'metrics.csv'))
    assert list(got[0]) == list(ref[0]) == ['epoch', 'split', 'loss',
                                            'n_inter_edge', 'time']
    assert len(got) == len(ref) == 2
    for a, b in zip(got, ref):
        assert (a['epoch'], a['split'], a['n_inter_edge']) == \
            (b['epoch'], b['split'], b['n_inter_edge'])
        np.testing.assert_allclose(float(a['loss']), float(b['loss']),
                                   rtol=FIT_RTOL)
    assert trainer.task.step == int(jstate.step) == 4
    assert [t['steps'] for t in trainer.epoch_times] == [2, 2]
    best = min(range(2), key=lambda e: float(ref[e]['loss']))
    for name in ('last', 'best'):
        path = osp.join(tdir, 'checkpoints', name)
        assert osp.exists(osp.join(path, 'state.pt'))
        meta = json.load(open(osp.join(path, 'spt_meta.json')))
        assert meta['epoch'] == (2 if name == 'last' else best + 1)
    # the saved last state is the trained one
    state = torch.load(osp.join(tdir, 'checkpoints', 'last', 'state.pt'),
                       weights_only=True)
    assert state['step'] == 4 and all(
        torch.equal(v, trainer.task.model.state_dict()[k])
        for k, v in state['model'].items())


def test_fit_partition_raises_without_inter_edges(tmp_path):
    """An epoch whose labels never differ across an edge raises."""
    nags = _nags(tsyn)
    for n in nags:
        n[0]['y'] = np.zeros_like(n[0].y)

    class Loader:
        def __iter__(self):
            yield [n.clone() for n in nags]

    task = tpart.PartitionTask(
        tpart.PartitionModel(8, channels=CHANNELS, num_graphs=2),
        num_classes=NUM_CLASSES, **TASK_HP)
    with pytest.raises(RuntimeError, match='no inter edge'):
        ttrainer.fit_partition(task, Loader(), TCFG,
                               output_dir=str(tmp_path), max_epochs=1)


# -- stage 2 preprocessing -------------------------------------------------

def test_preprocess_contour_prior_without_checkpoint_matches_jax(rooms):
    raw = rooms[2]
    got = tpre.preprocess_cloud(raw.clone(), **PRE, **CONTOUR)
    ref = jpre.preprocess_cloud(jsyn.synthetic_room_cloud(
        seed=0, n_points=ROOM_POINTS), **PRE, **CONTOUR)
    assert_nags_equal(got, ref, 0)
    assert got.num_levels == 4
    assert got[0].num_nodes > got[1].num_nodes > got[2].num_nodes


def _capture(monkeypatch, module, store):
    """Record the features that `module`'s preprocess_cloud hands to the
    greedy partition."""
    fn = module.greedy_contour_prior_partition

    def recording(data, **kw):
        store.append(np.asarray(data.x).copy())
        return fn(data, **kw)

    monkeypatch.setattr(module, 'greedy_contour_prior_partition',
                        recording)


def test_preprocess_with_stage1_checkpoint_matches_jax(rooms, fits,
                                                       tmp_path,
                                                       monkeypatch):
    """The port's `torch.save` checkpoint of the JAX stage-1 weights (the
    JAX Trainer's orbax `last`, loaded through `load_jax_params`) gives
    the frozen CNN's embeddings of JAX's orbax checkpoint within CNN_TOL;
    given JAX's embeddings exactly, the port's partition and NAG are
    JAX's, bit for bit."""
    import orbax.checkpoint as ocp
    jckpt = osp.join(fits[0], 'checkpoints', 'last')
    params = ocp.StandardCheckpointer().restore(jckpt)['params']
    model = tpart.PartitionModel(8, channels=CHANNELS, num_graphs=1)
    load_jax_params(model, params)
    task = tpart.PartitionTask(model, num_classes=NUM_CLASSES)
    tckpt = tmp_path / 'last'
    tckpt.mkdir()
    torch.save(task.state_dict(), tckpt / 'state.pt')

    kw = dict(PRE, **CONTOUR, pretrained_cnn_channels=CHANNELS)
    jx, tx = [], []
    _capture(monkeypatch, jpre, jx)
    _capture(monkeypatch, tpre, tx)
    ref = jpre.preprocess_cloud(jsyn.synthetic_room_cloud(
        seed=0, n_points=ROOM_POINTS), pretrained_cnn_ckpt_path=jckpt, **kw)
    tpre.preprocess_cloud(rooms[2].clone(), pretrained_cnn_ckpt_path=str(
        tckpt), device='cpu', **kw)
    assert len(jx) == len(tx) == 1
    assert tx[0].shape == (rooms[1][0].num_nodes, CHANNELS[-1])
    np.testing.assert_allclose(tx[0], jx[0], rtol=CNN_TOL, atol=CNN_TOL)

    # the same embeddings on both sides: the port's CNN runs, then its
    # output is replaced by JAX's
    cnn = tpre.pretrained_cnn_features

    def jax_embeddings(data, **k):
        data = cnn(data, **k)
        data['x'] = jx[0]
        return data

    monkeypatch.setattr(tpre, 'pretrained_cnn_features', jax_embeddings)
    got = tpre.preprocess_cloud(rooms[2].clone(),
                                pretrained_cnn_ckpt_path=str(tckpt),
                                device='cpu', **kw)
    assert_nags_equal(got, ref, 0)
    # and the same state_dict given directly
    data = _level0(rooms[1], TData)
    data['x'] = np.concatenate([data.x, data.x[:, :3]], 1)
    a = tpre.pretrained_cnn_features(data.clone(), ckpt_path=str(tckpt),
                                     channels=CHANNELS, voxel=0.1,
                                     device='cpu')
    b = tpre.pretrained_cnn_features(data.clone(),
                                     params=model.state_dict(),
                                     channels=CHANNELS, voxel=0.1,
                                     device='cpu')
    np.testing.assert_array_equal(a.x, b.x)


def test_pretrained_cnn_runs_on_the_card_unless_asked_for_the_cpu(rooms):
    data = _level0(rooms[1], TData)
    data['x'] = np.concatenate([data.x, data.x[:, :3]], 1)
    model = tpart.PartitionModel(8, channels=CHANNELS, num_graphs=1)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match='no CUDA device'):
            tpre.pretrained_cnn_features(data.clone(),
                                         params=model.state_dict(),
                                         channels=CHANNELS)
    out = tpre.pretrained_cnn_features(data.clone(),
                                       params=model.state_dict(),
                                       channels=CHANNELS, device='cpu')
    assert out.x.shape == (data.num_nodes, CHANNELS[-1])


# -- configs, entry points ---------------------------------------------------

def test_s3dis_ezsp_cache_hash_matches_jax(tmp_path):
    """The stage-2 datamodule's preprocessing config, and so the cache
    hash, are JAX's; the CNN's device is no part of them."""
    argv = ['experiment=semantic/s3dis_ezsp',
            f'datamodule.pretrained_cnn_ckpt_path={tmp_path}/last']
    tcfg = tload(ttrain.CONFIG_DIR, 'train', argv + ['device=cpu'])
    jcfg = jload(ttrain.CONFIG_DIR, 'train', argv)
    got, ref = texp._pre_transform_config(tcfg), jpre_cfg(jcfg)
    assert got == ref and got['partition_mode'] == 'contour_prior'
    tds = TBaseDataset(str(tmp_path), pre_transform_config=got,
                       device='cpu')
    jds = JBaseDataset(str(tmp_path), pre_transform_config=ref)
    assert tds.pre_transform_hash == jds.pre_transform_hash
    # stage 1 preprocesses as the semantic experiment does: one cache
    p1 = texp._pre_transform_config(tload(
        ttrain.CONFIG_DIR, 'train', ['experiment=partition/s3dis_ezsp']))
    assert p1 == texp._pre_transform_config(tload(
        ttrain.CONFIG_DIR, 'train', ['experiment=semantic/s3dis']))


def test_stage1_and_stage2_feature_orders_are_jax_s(rooms):
    """Observation, mirrored and not changed: stage 1 trains the CNN on
    `point_hf` (S3DIS: linearity, planarity, scattering, verticality,
    elevation, rgb), stage 2 runs it on `partition_hf` (rgb first). Both
    are 8 columns wide and both rescale rgb over 1.5 by 1/255, so
    nothing raises."""
    c1 = tload(ttrain.CONFIG_DIR, 'train', ['experiment=partition/s3dis_ezsp'])
    c2 = tload(ttrain.CONFIG_DIR, 'train', ['experiment=semantic/s3dis_ezsp'])
    j1 = jload(ttrain.CONFIG_DIR, 'train', ['experiment=partition/s3dis_ezsp'])
    order1, order2 = list(c1.datamodule.point_hf), \
        list(c2.datamodule.partition_hf)
    assert order1 == list(j1.datamodule.point_hf) == [
        'linearity', 'planarity', 'scattering', 'verticality', 'elevation',
        'rgb']
    assert order2 == ['rgb', 'linearity', 'planarity', 'scattering',
                      'verticality', 'elevation']
    assert texp._dims(order1) == texp._dims(order2) == 8
    nag = rooms[1]
    d0 = nag[0]
    x1 = tprep.prepare_partition_batch(
        [nag], tprep.BatchConfig(point_hf=tuple(order1)), train=False).x
    n = d0.num_nodes
    np.testing.assert_array_equal(x1[:n, :5], np.concatenate(
        [d0[k] for k in order1[:5]], 1))
    rgb = np.asarray(d0.rgb, np.float32)
    rgb = rgb / 255.0 if rgb.max() > 1.5 else rgb
    np.testing.assert_array_equal(x1[:n, 5:], rgb)
    x2 = tpre.add_keys_to(TData(**{k: d0[k] for k in order2}), order2).x
    np.testing.assert_array_equal(x2[:, :3], rgb)
    np.testing.assert_array_equal(x2[:, 3:], x1[:n, :5])


def test_build_task_partition_matches_the_config():
    cfg = tload(ttrain.CONFIG_DIR, 'train',
                ['experiment=partition/s3dis_ezsp', 'device=cpu'])
    task = texp.build_task(cfg, num_graphs=2, total_steps=7, device='cpu')
    assert isinstance(task, tpart.PartitionTask)
    cnn = task.model.cnn
    assert cnn.channels == [32, 32, 32]
    assert cnn.block_0.weight.shape == (32, 27 * 8)
    assert task.adaptive_sampling_ratio == 0.9 and task.focal_gamma == 1.0
    g = task.optimizer.param_groups
    assert len(g) == 1 and g[0]['lr'] == pytest.approx(1e-4) \
        and g[0]['weight_decay'] == pytest.approx(1e-4)
    # the generator's weights: the same seed, the same draws
    again = texp.build_task(cfg, num_graphs=2, device='cpu')
    assert all(torch.equal(a, b) for a, b in zip(
        task.model.parameters(), again.model.parameters()))
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match='no CUDA device'):
            texp.build_task(cfg)


def test_ezsp_demo_runs_on_a_synthetic_room(rooms):
    """`run_ezsp_demo` on a preprocessed room: the loss falls, the learned
    partition compresses, and the cut-pursuit oracle is JAX's."""
    res = run_ezsp_demo(rooms[1], steps=15, channels=(16, 16),
                        device='cpu')
    jres = joracle.semantic_segmentation_oracle(
        np.asarray(rooms[0][1].y)[:, :NUM_CLASSES].astype(np.int64),
        NUM_CLASSES)
    assert res['cutpursuit_oracle_miou'] == float(jres['miou'])
    assert res['loss_last'] < res['loss_first']
    assert 1 < res['learned_n_segments'] < res['n_voxels']
    assert 0 < res['learned_oracle_miou'] <= 100
