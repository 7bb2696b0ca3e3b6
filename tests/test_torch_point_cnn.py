"""The SPT's sparse-CNN point stage (EZ-SP semantic, `point_cnn`) against
the JAX package on the CPU: the kernel-neighbor table `cnn_nbr_idx` that
`pad_nag` builds from level-0 `coords` (and carries through `from_numpy`,
`strip_for_inference` and `stack_batches`), the instance and layer norms
of the sparse convolution blocks, a narrow `point_cnn` SPT with both
`point_cnn_into_mlp` settings (logits, one train step), and a
reference-keyed state dict (`net.first_stage.cnn_blocks.*`) imported with
`strict=True`.

Tolerances are test_torch_variants.py's: 1e-5 for a module, 1e-4 for the
logits, 1e-4 relative for the loss, and its `check_grads` for the
gradients."""
import dataclasses

import numpy as np
import pytest
import torch

import jax

from superpoint_transformer_tpu.models.semantic import (
    SemanticSegmentationModel as JModel, SemanticTask as JTask)
from superpoint_transformer_tpu.models.spt import SPT as JSPT
from superpoint_transformer_tpu.nn.sparse import SparseCNN as JSparseCNN
from superpoint_transformer_tpu.transforms import (
    BatchConfig as JBatchConfig, prepare_batch as jprepare)
from superpoint_transformer_tpu.transforms.preprocess import (
    quantize_coordinates as jquantize)
from superpoint_transformer_tpu.utils.synthetic import random_nag as jnag
from superpoint_transformer_torch.data.padded import (from_numpy,
                                                      strip_for_inference)
from superpoint_transformer_torch.inference import stack_batches
from superpoint_transformer_torch.models.semantic import (
    SemanticSegmentationModel as TModel, SemanticTask)
from superpoint_transformer_torch.models.spt import SPT as TSPT
from superpoint_transformer_torch.nn.sparse import SparseCNN as TSparseCNN
from superpoint_transformer_torch.transforms.prepare import (BatchConfig,
                                                             prepare_batch)
from superpoint_transformer_torch.transforms.preprocess import (
    quantize_coordinates)
from superpoint_transformer_torch.utils.import_ckpt import (
    import_reference_checkpoint, reference_state_dict)
from superpoint_transformer_torch.utils.jax_params import load_jax_params
from superpoint_transformer_torch.utils.synthetic import random_nag
from test_torch_variants import (TOL_LOSS, TOL_SPT, _apply, _close, _t, _j,
                                 _variables, check_grads)

VOXEL = 0.5
CNN = (8, 8)
# the narrow SPT of test_torch_spt.py, one block a stage; the CNN reads
# the 8 point features. Into the MLP: its 8 channels replace them
# (12 = 3 + 1 + 8); beside it: the MLP makes 24 and the CNN's 8 are
# concatenated
NARROW = dict(down_dim=(32, 32),
              down_in_mlp=((36, 32, 32), (36, 32, 32)), down_num_heads=4,
              down_num_blocks=1, up_dim=(32,), up_in_mlp=((68, 32, 32),),
              up_num_heads=4, up_num_blocks=1, h_edge_mlp=(18, 16, 16),
              in_rpe_dim=16, qk_dim=4, num_graphs=2, point_cnn=CNN)
INTO = {True: dict(point_mlp=(12, 16, 32), point_cnn_into_mlp=True),
        False: dict(point_mlp=(12, 16, 24), point_cnn_into_mlp=False)}


def _nags(make, quantize):
    """Two NAGs whose level-0 points lie in distinct voxels of a 10^3
    grid, half of it filled (so that most voxels have neighbors), their
    coords from `quantize_coordinates`."""
    out = []
    for seed in (0, 1):
        nag = make(seed=seed)
        n = nag[0].num_nodes
        cells = np.random.default_rng(seed).permutation(1000)[:n]
        grid = np.stack(np.unravel_index(cells, (10, 10, 10)), 1)
        nag[0]['pos'] = ((grid + 0.5) * VOXEL).astype(np.float32)
        quantize(nag[0], size=VOXEL)
        out.append(nag)
    return out


@pytest.fixture(scope='module')
def batches():
    """The JAX host path's batch of two NAGs with level-0 voxel coords
    (JAX arrays, as its models take them), and the port's from the same
    NAGs (numpy leaves)."""
    cfg = dict(sample_graph_r=-1, sample_segment_ratio=0)
    j = jprepare(_nags(jnag, jquantize), JBatchConfig(**cfg), train=False)
    t = prepare_batch(_nags(random_nag, quantize_coordinates),
                      BatchConfig(**cfg), train=False)
    return j, t


def test_pad_nag_builds_cnn_nbr_idx_as_jax(batches):
    """The table [N0, 27] int32 equals JAX's; it crosses to a device
    batch, survives `strip_for_inference` and stacks."""
    j, t = batches
    ref = np.asarray(j.levels[0].cnn_nbr_idx)
    got = t.levels[0].cnn_nbr_idx
    assert got.dtype == np.int32 and got.shape == ref.shape
    np.testing.assert_array_equal(got, ref)
    assert (got >= 0).sum(1).max() > 1      # voxels have neighbors
    stripped = strip_for_inference(t)
    np.testing.assert_array_equal(stripped.levels[0].cnn_nbr_idx, ref)
    dev = from_numpy(stripped, 'cpu')
    assert torch.equal(dev.levels[0].cnn_nbr_idx, torch.from_numpy(
        ref.astype(np.int64)))
    stacked = stack_batches([stripped, stripped])
    assert stacked.levels[0].cnn_nbr_idx.shape == (2,) + ref.shape


@pytest.mark.parametrize('norm', ['instance', 'layer'])
def test_sparse_cnn_norms_match_jax(batches, norm):
    j = batches[0].levels[0]
    x = np.asarray(j.x)
    jm = JSparseCNN(channels=CNN, norm=norm, num_graphs=2)
    args = (_j(x), _j(j.cnn_nbr_idx))
    kw = dict(batch=_j(j.batch), mask=_j(j.node_mask))
    v = _variables(jm, *args, **kw)
    tm = load_jax_params(TSparseCNN(8, CNN, norm=norm, num_graphs=2),
                         v['params'])
    assert hasattr(tm.block_0, f'{norm.capitalize()}Norm_0')
    got = tm(_t(x), _t(j.cnn_nbr_idx), batch=_t(j.batch),
             mask=_t(j.node_mask))
    _close(got, _apply(jm, v, *args, **kw))


@pytest.fixture(scope='module')
def jax_runs(batches):
    """For each `into` setting: variables, logits, one step's loss and
    gradients, and JAX's one-ulp gradient spread."""
    b = batches[0]
    out = {}
    rng = jax.random.PRNGKey(0)
    for into, kw in INTO.items():
        net = dict(NARROW, **kw)
        jm = JModel(net=JSPT(**net), num_classes=13)
        v = _variables(jm, b, train=False)
        task = JTask(net=JSPT(**net), num_classes=13)
        step = jax.jit(jax.value_and_grad(
            lambda p: task._loss_fn(p, b, rng)[0]))
        loss, grads = step(v['params'])
        noise = np.random.default_rng(9)
        moved = jax.tree_util.tree_map(lambda a: (np.asarray(a) * (
            1 + 2.0 ** -23 * noise.standard_normal(a.shape))).astype(
            np.float32), v['params'])
        spread = jax.tree_util.tree_map(
            lambda a, c: float(np.abs(np.asarray(a) - np.asarray(c)).max()),
            grads, step(moved)[1])
        out[into] = dict(v=v, logits=[np.asarray(x) for x in _apply(
            jm, v, b, train=False)], loss=float(loss), grads=grads,
            spread=spread)
    return out


def _port_model(into, v):
    net = TSPT(**NARROW, **INTO[into], point_hf_dim=8)
    return load_jax_params(TModel(net, 13), v['params'])


@pytest.mark.parametrize('into', [True, False])
def test_point_cnn_spt_logits_match_jax(batches, jax_runs, into):
    j, t = batches
    ref = jax_runs[into]
    model = _port_model(into, ref['v']).eval()
    assert model.net.first_stage.out_dim == 32
    with torch.no_grad():
        got = model(from_numpy(t, 'cpu'))
    for lvl, g, r in zip(j.levels[1:], got, ref['logits']):
        _close(g, r, tol=TOL_SPT, valid=np.asarray(lvl.node_mask))


@pytest.mark.parametrize('into', [True, False])
def test_point_cnn_spt_train_step_matches_jax(batches, jax_runs, into):
    t, ref = batches[1], jax_runs[into]
    task = SemanticTask(TSPT(**NARROW, **INTO[into], point_hf_dim=8),
                        num_classes=13)
    load_jax_params(task.model, ref['v']['params'])
    task.model.train()
    loss, _ = task.loss(from_numpy(t, 'cpu', train=True))
    loss.backward()
    np.testing.assert_allclose(loss.item(), ref['loss'], rtol=TOL_LOSS)
    cnn = task.model.net.first_stage.cnn.block_1.weight
    assert cnn.grad.abs().max() > 0
    check_grads(task.model, ref['grads'], ref['spread'])


def test_reference_checkpoint_imports_into_the_point_cnn_spt(batches,
                                                             jax_runs):
    """A state dict under the reference's keys, made from the model's own
    weights (`reference_state_dict`), imports into a fresh model with
    `strict=True` and serves the same logits bit for bit."""
    t = from_numpy(batches[1], 'cpu')
    a = _port_model(True, jax_runs[True]['v']).eval()
    state = reference_state_dict(a)
    kernel = state['net.first_stage.cnn_blocks.0.conv.kernel']
    assert kernel.shape == (27, 8, CNN[0])
    assert 'net.first_stage.cnn_blocks.1.norm.mean_scale' in state
    b = TModel(TSPT(**NARROW, **INTO[True], point_hf_dim=8), 13).eval()
    report = import_reference_checkpoint(state, b, strict=True)
    assert not report['missing'] and not report['unused_reference_keys']
    with torch.no_grad():
        for x, y in zip(a(t), b(t)):
            assert torch.equal(x, y)


def test_point_cnn_needs_the_table(batches):
    """A batch without `cnn_nbr_idx` (no level-0 coords) is refused."""
    t = batches[1]
    bare = dataclasses.replace(t, levels=(dataclasses.replace(
        t.levels[0], cnn_nbr_idx=None),) + tuple(t.levels[1:]))
    model = TModel(TSPT(**NARROW, **INTO[True], point_hf_dim=8), 13).eval()
    with pytest.raises(ValueError, match='cnn_nbr_idx'):
        model(from_numpy(bare, 'cpu'))
