"""The port's run utilities against the JAX package on the CPU, on a small
synthetic room preprocessed by each package (the repository holds no
demo NAG): `add_pseudo_instances`, `split_nag_spatially`, and 2 steps of
`run_heldout` and `run_supercluster_demo` with a narrow f32 SPT.

The JAX functions initialise their task inside (`init_state(
PRNGKey(seed), ...)`); the test rebuilds those parameters with the same
key (a flax tree's values depend on the key and the shapes alone) and
loads them into the port's task, which the port's functions take built.
Both sides draw the same crops from the same numpy seeds. The host code
is the same numpy code on both sides, so its results must be equal; the
losses are held to 1e-4 relative (tests/test_torch_train.py's f32
tolerance) and the confusion and panoptic metrics, computed from argmaxes
and partitions of logits that agree to ~1e-5, to 1e-12.
"""
import numpy as np
import pytest

import jax

from superpoint_transformer_tpu.models import panoptic as jpan
from superpoint_transformer_tpu.models.semantic import SemanticTask as JTask
from superpoint_transformer_tpu.models.spt import SPT as JSPT
from superpoint_transformer_tpu.transforms import prepare as jprep
from superpoint_transformer_tpu.transforms import preprocess as jpre
from superpoint_transformer_tpu.utils import heldout as jheld
from superpoint_transformer_tpu.utils import pseudo_instances as jpseudo
from superpoint_transformer_tpu.utils import supercluster_demo as jdemo
from superpoint_transformer_tpu.utils import synthetic as jsyn
from superpoint_transformer_torch.data.csr import InstanceData as TInst
from superpoint_transformer_torch.models import panoptic as tpan
from superpoint_transformer_torch.models.semantic import SemanticTask
from superpoint_transformer_torch.models.spt import SPT as TSPT
from superpoint_transformer_torch.transforms import preprocess as tpre
from superpoint_transformer_torch.utils import heldout as theld
from superpoint_transformer_torch.utils import pseudo_instances as tpseudo
from superpoint_transformer_torch.utils import supercluster_demo as tdemo
from superpoint_transformer_torch.utils import synthetic as tsyn
from superpoint_transformer_torch.utils.jax_params import load_jax_params
from test_torch_host_path import PRE, assert_arrays_equal, assert_nags_equal
from test_torch_train import HPARAMS, NARROW, TOL_F32

ROOM_POINTS = 20_000
NUM_CLASSES = 13
STEPS = 2
CROPS = NARROW['num_graphs']
METRIC_TOL = 1e-12
SEED = 0


@pytest.fixture(scope='module')
def rooms():
    """(JAX NAG, port NAG) of one small room."""
    return (jpre.preprocess_cloud(
                jsyn.synthetic_room_cloud(seed=0, n_points=ROOM_POINTS),
                **PRE),
            tpre.preprocess_cloud(
                tsyn.synthetic_room_cloud(seed=0, n_points=ROOM_POINTS),
                **PRE))


def _assert_instances_equal(name, got, ref):
    assert isinstance(got, TInst), name
    assert_arrays_equal(name + ' pointers', got.pointers, ref.pointers, 0)
    for j, (a, b) in enumerate(zip(got.values, ref.values)):
        assert_arrays_equal(f'{name} values {j}', a, b, 0)


@pytest.mark.parametrize('min_size', [4, 40])
def test_add_pseudo_instances_matches_jax(rooms, min_size):
    ref, ref_info = jpseudo.add_pseudo_instances(rooms[0].clone(),
                                                 min_size=min_size)
    got, info = tpseudo.add_pseudo_instances(rooms[1].clone(),
                                             min_size=min_size)
    assert info == ref_info and info['n_instances'] > 0
    assert info['n_void_voxels'] > 0 or min_size == 4
    for i in (0, 1):
        _assert_instances_equal(f'level {i} obj', got[i].obj, ref[i].obj)


@pytest.mark.parametrize('gap', [0.0, 0.3])
def test_split_nag_spatially_matches_jax(rooms, gap):
    ref = jheld.split_nag_spatially(rooms[0], gap=gap)
    got = theld.split_nag_spatially(rooms[1], gap=gap)
    for g, r in zip(got, ref):
        assert g[1].num_nodes > 0
        assert_nags_equal(g, r, 0)
    n = rooms[1][1].num_nodes
    assert (got[0][1].num_nodes + got[1][1].num_nodes < n) == (gap > 0)


def _init_params(jtask, nag, instance=False):
    """The parameters the JAX function draws in `init_state`."""
    cfg = jprep.BatchConfig(instance=instance)
    example = jprep.prepare_batch([nag] * CROPS, cfg, train=True,
                                  rng=np.random.default_rng(0),
                                  device=False)
    params = jtask.init_state(jax.random.PRNGKey(SEED), example).params
    return jax.tree_util.tree_map(np.array, params)


def _assert_results_match(got, ref, exact):
    assert set(got) == set(ref)
    for k in ('loss_first', 'loss_last'):
        assert np.isfinite(got[k]), k
        np.testing.assert_allclose(got[k], ref[k], rtol=TOL_F32['loss'],
                                   err_msg=k)
    for k in exact:
        np.testing.assert_allclose(got[k], ref[k], rtol=METRIC_TOL,
                                   atol=METRIC_TOL, equal_nan=True,
                                   err_msg=k)


def test_run_heldout_matches_jax(rooms):
    """2 steps on 2-crop batches of one half, evaluated on the other:
    the same losses, the same confusion metrics, the same oracle."""
    (jlo, jhi), (tlo, thi) = (jheld.split_nag_spatially(r) for r in rooms)
    jtask = JTask(net=JSPT(compute_dtype=None, **NARROW),
                  num_classes=NUM_CLASSES, **HPARAMS)
    ttask = SemanticTask(TSPT(compute_dtype=None, **NARROW),
                         num_classes=NUM_CLASSES, **HPARAMS)
    load_jax_params(ttask.model, _init_params(jtask, jlo))
    ref = jheld.run_heldout(jlo, jhi, steps=STEPS, crops=CROPS, seed=SEED,
                            task=jtask, pool=STEPS, log=None)
    got = theld.run_heldout(tlo, thi, steps=STEPS, crops=CROPS, seed=SEED,
                            task=ttask, pool=STEPS, log=None)
    _assert_results_match(got, ref, (
        'miou', 'oa', 'macc', 'oracle_miou', 'oracle_oa', 'steps', 'crops',
        'train_nodes_l1', 'eval_nodes_l1'))
    assert 0 <= got['miou'] <= 100 and got['oa'] <= got['oracle_oa']
    assert ttask.step == STEPS


def test_run_supercluster_demo_matches_jax(rooms):
    """2 panoptic steps on 2-crop batches with pseudo-instances, then the
    grid search and the cross-oracle PQs on the whole room: the same
    losses, settings, PQ/SQ/RQ, mAP and instance counts."""
    kw = dict(num_classes=NUM_CLASSES, **HPARAMS)
    jtask = jpan.PanopticTask(net=JSPT(compute_dtype=None, **NARROW), **kw)
    ttask = tpan.PanopticTask(TSPT(compute_dtype=None, **NARROW), **kw)
    nag_j, _ = jpseudo.add_pseudo_instances(rooms[0].clone())
    load_jax_params(ttask.model, _init_params(jtask, nag_j, instance=True))
    args = dict(steps=STEPS, crops=CROPS, seed=SEED, pool=STEPS,
                edge_affinity_loss_weights=(1., 2., 3., 4.),
                log=lambda *_: None)
    ref = jdemo.run_supercluster_demo(rooms[0], task=jtask, **args)
    got = tdemo.run_supercluster_demo(rooms[1], task=ttask, **args)
    assert got['settings'] == ref['settings']
    assert got['n_pseudo_instances'] > 0
    exact = [k for k, v in ref.items() if isinstance(v, (int, float))
             and k not in ('loss_first', 'loss_last', 'wall_sec')]
    assert {'pq', 'sq', 'rq', 'map', 'oracle_pq', 'n_pred_instances',
            'pq_trained_logits_oracle_affinity',
            'pq_oracle_logits_trained_affinity',
            'semantic_miou_level1'} <= set(exact)
    _assert_results_match(got, ref, exact)
    for k in ('pq', 'sq', 'rq'):
        assert 0 <= got[k] <= 100, k
    assert rooms[1][1].get('obj') is None   # the demo worked on a clone
