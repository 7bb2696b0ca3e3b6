"""The port's preprocessing options against the JAX package on the CPU:
the Delaunay horizontal graph (on its own and through
`preprocess_cloud(graph_builder='delaunay')`, then a narrow f32 SPT's
`eval_step` on that NAG with JAX's weights), the knn and mlp ground
models, `grid_partition` and `d0_partition_energy`.

Both sides run the same numpy code, Qhull and native sources on the same
inputs and draw from `rng` in the same order. Qhull's output turns on
the exact float64 input, so the graphs must be equal, not close: integer
arrays equal, the edge features within 1e-6, the ground elevations
within 1e-6, the d0 energy within 1e-12 relative. The model's tolerance
is tests/test_torch_train.py's.
"""
import numpy as np
import pytest

import jax

from superpoint_transformer_tpu.models.semantic import (
    SemanticTask as JTask, TrainState)
from superpoint_transformer_tpu.models.spt import SPT as JSPT
from superpoint_transformer_tpu.optim.lr_scheduler import make_optimizer
from superpoint_transformer_tpu.transforms import prepare as jprep
from superpoint_transformer_tpu.transforms import preprocess as jpre
from superpoint_transformer_tpu.utils import synthetic as jsyn
from superpoint_transformer_torch.data.padded import from_numpy
from superpoint_transformer_torch.models.semantic import SemanticTask
from superpoint_transformer_torch.models.spt import SPT as TSPT
from superpoint_transformer_torch.transforms import preprocess as tpre
from superpoint_transformer_torch.utils import synthetic as tsyn
from superpoint_transformer_torch.utils.jax_params import load_jax_params
from test_torch_host_path import PRE, assert_arrays_equal, assert_nags_equal
from test_torch_train import HPARAMS, NARROW, TOL_F32, _params

ROOM_POINTS = 10_000
EDGE_ATTR_ATOL = 1e-6
ELEVATION_ATOL = 1e-6
ENERGY_RTOL = 1e-12


def _raw_pair(seed, n_points=ROOM_POINTS):
    return (jsyn.synthetic_room_cloud(seed=seed, n_points=n_points),
            tsyn.synthetic_room_cloud(seed=seed, n_points=n_points))


@pytest.fixture(scope='module')
def delaunay_rooms():
    """One room through each package's `preprocess_cloud` with the
    Delaunay graph: (JAX NAG, port NAG)."""
    raw_j, raw_t = _raw_pair(0)
    return (jpre.preprocess_cloud(raw_j, graph_builder='delaunay', **PRE),
            tpre.preprocess_cloud(raw_t, graph_builder='delaunay', **PRE))


def _assert_graphs_equal(got, ref):
    for i in ref.levels[1:]:
        assert ref[i].edge_index.shape[1] > 0, i
        assert_arrays_equal(f'level {i} edge_index', got[i].edge_index,
                            ref[i].edge_index, 0)
        assert got[i].edge_attr.dtype == ref[i].edge_attr.dtype
        np.testing.assert_allclose(got[i].edge_attr, ref[i].edge_attr,
                                   rtol=0, atol=EDGE_ATTR_ATOL,
                                   err_msg=f'level {i} edge_attr')


def test_preprocess_cloud_delaunay_matches_jax(delaunay_rooms):
    """Every key of every level of the Delaunay NAG, the graph and its
    features included, equal to JAX's (floats to 1e-6 relative here, as
    in test_torch_host_path.py; they come out bit-equal)."""
    ref, got = delaunay_rooms
    _assert_graphs_equal(got, ref)
    assert_nags_equal(got, ref, EDGE_ATTR_ATOL)
    # the 7 features: mean offset, std offset, then the mean distance
    # itself (not its square root, as the radius graph stores)
    ea = got[1].edge_attr
    assert ea.shape[1] == 7 and (ea[:, 6] > 0).all()


@pytest.mark.parametrize('max_dist', [-1, 0.4], ids=['no_cap', 'max_dist'])
def test_delaunay_horizontal_graph_matches_jax(max_dist):
    """The graph alone on a radius-graph NAG of each package, from one
    rng seed; with `max_dist` the filter drops long edges but keeps the
    shortest edge of a node it would isolate, so no node loses its
    last edge."""
    raw_j, raw_t = _raw_pair(1)
    ref = jpre.delaunay_horizontal_graph(
        jpre.preprocess_cloud(raw_j, **PRE), max_dist=max_dist,
        rng=np.random.default_rng(5))
    got = tpre.delaunay_horizontal_graph(
        tpre.preprocess_cloud(raw_t, **PRE), max_dist=max_dist,
        rng=np.random.default_rng(5))
    _assert_graphs_equal(got, ref)
    if max_dist > 0:
        for i in got.levels[1:]:
            ei, ea = got[i].edge_index, got[i].edge_attr
            long = ea[:, 6] > max_dist
            assert (~long).any()
            deg = np.bincount(ei.ravel(), minlength=got[i].num_nodes)
            assert (deg > 0).all(), i


@pytest.fixture(scope='module')
def eval_batch(delaunay_rooms):
    """A 2-graph evaluation batch of the Delaunay NAG (JAX host path),
    with label histograms."""
    cfg = jprep.BatchConfig(sample_graph_r=-1, sample_segment_ratio=0)
    return jprep.prepare_batch([delaunay_rooms[0]] * 2, cfg, train=False,
                               device=False)


def test_eval_step_on_the_delaunay_nag_matches_jax(eval_batch):
    """The narrow f32 SPT's `eval_step` with JAX's weights: the loss
    within 1e-4 relative, the level-1 logits of the valid nodes within
    1e-4 of their largest entry, and the confusion matrix equal."""
    jt = JTask(net=JSPT(compute_dtype=None, **NARROW), num_classes=13,
               **HPARAMS)
    params = _params(jt.model, eval_batch)
    state = TrainState.create(apply_fn=jt.model.apply, params=params,
                              tx=make_optimizer(params=params))
    ref = {k: np.asarray(v)
           for k, v in jt.eval_step(state, eval_batch).items()}
    tt = SemanticTask(TSPT(compute_dtype=None, **NARROW), num_classes=13,
                      **HPARAMS)
    load_jax_params(tt.model, jax.tree_util.tree_map(np.array, params))
    got = {k: v.numpy() for k, v in tt.eval_step(
        from_numpy(eval_batch, 'cpu', None, train=True)).items()}
    np.testing.assert_allclose(got['loss'], ref['loss'],
                               rtol=TOL_F32['loss'])
    valid = np.asarray(eval_batch.levels[1].node_mask)
    a, b = got['logits_level1'][valid], ref['logits_level1'][valid]
    err, scale = np.abs(a - b).max(), np.abs(b).max()
    assert err <= TOL_F32['rel'] * scale, f'{err:.3e} of {scale:.3e}'
    np.testing.assert_array_equal(got['confmat'], ref['confmat'])


@pytest.mark.parametrize('model', ['knn', 'mlp', 'ransac'])
def test_ground_elevation_matches_jax(model):
    """The ground models on a room whose candidate cells thin out (more
    than 1000 candidates), from one rng seed each side."""
    raw_j, raw_t = _raw_pair(2, n_points=5_000)
    ref = jpre.ground_elevation(raw_j, model=model,
                                rng=np.random.default_rng(3)).elevation
    got = tpre.ground_elevation(raw_t, model=model,
                                rng=np.random.default_rng(3)).elevation
    assert got.shape == ref.shape == (raw_t.num_nodes, 1)
    assert got.dtype == ref.dtype == np.float32
    np.testing.assert_allclose(got, ref, rtol=0, atol=ELEVATION_ATOL)
    assert ref.std() > 0


def test_ground_elevation_rejects_an_unknown_model():
    raw = tsyn.synthetic_room_cloud(seed=0, n_points=2_000)
    with pytest.raises(ValueError, match='plane'):
        tpre.ground_elevation(raw, model='plane')


def _grid_input(pkg_pre, syn):
    """A voxelized room with KNN adjacency and features, as the partition
    sees it."""
    data = syn.synthetic_room_cloud(seed=3, n_points=5_000)
    data = pkg_pre.grid_sampling(data, 0.1, hist_key='y', hist_size=14)
    data = pkg_pre.knn_search(data, k=10, r_max=1.0)
    data = pkg_pre.adjacency_graph(data, k=10)
    data['x'] = np.asarray(data.rgb, np.float32)
    return data


@pytest.mark.parametrize('mode', ['xy', 'xyz'])
def test_grid_partition_matches_jax(mode):
    ref = jpre.grid_partition(_grid_input(jpre, jsyn), sizes=(0.5, 2.0),
                              mode=mode)
    got = tpre.grid_partition(_grid_input(tpre, tsyn), sizes=(0.5, 2.0),
                              mode=mode)
    assert got.num_levels == 3 and got[2].num_nodes > 1
    assert got[1].edge_index.shape[1] > 0
    assert_nags_equal(got, ref, 0)


def test_d0_partition_energy_matches_jax():
    rng = np.random.default_rng(4)
    n = 500
    feats = rng.normal(size=(n, 6)).astype(np.float32)
    ei = rng.integers(0, n, (2, 3_000))
    ew = rng.random(3_000).astype(np.float32)
    nw = rng.integers(1, 5, n)
    sup = rng.integers(0, 40, n)
    ref = jpre.d0_partition_energy(feats, ei, ew, nw, sup, 0.3)
    got = tpre.d0_partition_energy(feats, ei, ew, nw, sup, 0.3)
    np.testing.assert_allclose(got, ref, rtol=ENERGY_RTOL, atol=0)
    assert got[1] > 0 and got[2] > 0
    np.testing.assert_allclose(got[0], got[1] + got[2], rtol=ENERGY_RTOL)
