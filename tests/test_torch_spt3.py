"""SPT-3 (three down stages, two up stages: `semantic/spt-3`, and
`panoptic/spt-3` with SuperCluster's edge-affinity head) in the port vs
the JAX package, on the CPU, built from the experiment files of DALES,
KITTI-360 and ScanNet at narrow width (16 channels, 2 heads of qk_dim 4,
so H*D = 8 != C = 16, the point stage on; f32 unless stated).

The batches are the JAX host path's, from raw files that the port's
synthetic writers made (a DALES tile, a KITTI-360 window, a ScanNet scan
with instances, 4,000 points each; two clouds a batch), preprocessed with
each experiment's own configuration into 4-level NAGs; the port's host
path must give the same padded batch field by field. Weights come across
through `utils/jax_params.py`. Checked: the logits of the 3 levels (and
the edge-affinity logits on ScanNet) at tests/test_torch_spt.py's
tolerances, one training step's loss and every gradient at
tests/test_torch_train.py's, and that only levels 1 and 2 are supervised
(two `multi_stage_loss_lambdas`): the level-3 head has no gradient on
either side. The JAX model takes its XLA attention on the CPU, the port
the kernels' plain versions."""
import dataclasses
import functools
import os.path as osp

import numpy as np
import pytest
import torch

import jax

from superpoint_transformer_tpu import experiment as jexp
from superpoint_transformer_tpu.config.loader import load_config as jload
from superpoint_transformer_tpu.datasets import dales as jdales
from superpoint_transformer_tpu.datasets import kitti360 as jkitti
from superpoint_transformer_tpu.datasets import scannet as jscannet
from superpoint_transformer_tpu.models import panoptic as jpan
from superpoint_transformer_tpu.models.semantic import (
    SemanticSegmentationModel as JModel)
from superpoint_transformer_tpu.transforms import prepare as jprep
from superpoint_transformer_tpu.transforms import preprocess as jpre
from superpoint_transformer_torch import experiment as texp
from superpoint_transformer_torch.config.loader import load_config
from superpoint_transformer_torch.data.padded import from_numpy
from superpoint_transformer_torch.datasets import dales as tdales
from superpoint_transformer_torch.datasets import kitti360 as tkitti
from superpoint_transformer_torch.datasets import scannet as tscannet
from superpoint_transformer_torch.models import panoptic as tpan
from superpoint_transformer_torch.models.semantic import (
    SemanticSegmentationModel as TModel)
from superpoint_transformer_torch.transforms import prepare as tprep
from superpoint_transformer_torch.transforms import preprocess as tpre
from superpoint_transformer_torch.utils import synthetic as tsyn
from superpoint_transformer_torch.utils.jax_params import load_jax_params
from test_torch_host_path import assert_padded_equal
from test_torch_train import TOL_F32 as TOL_STEP
from test_torch_train import _flat, _params, _rel_l2

CONFIGS = osp.join(osp.dirname(osp.dirname(osp.abspath(__file__))),
                   'configs')
NARROW = ['model._point_mlp=[16,16,16]', 'model._down_dim=[16,16,16]',
          'model._up_dim=[16,16]', 'model.net.down_num_heads=2',
          'model.net.up_num_heads=2', 'trainer.precision=32']
POINTS = 4000
# f32 logits through the whole network (test_torch_spt.py's tolerance)
TOL_F32 = dict(rtol=1e-4, atol=1e-4)
# bf16: test_torch_spt.py's element, mean and argmax limits
TOL_BF16 = dict(rtol=0.1, atol=0.5)
MEAN_ABS_BF16 = 0.1
ARGMAX_AGREEMENT_BF16 = 0.85
# one bf16 step, port vs JAX, both in bf16 from the same parameters: the
# loss relative, and the gradients' relative L2 (all parameters
# flattened). Both round to bf16, XLA at fusion boundaries and PyTorch
# after every op, and the random-weight network amplifies each rounding:
# JAX's own bf16 gradients are 0.115-0.29 from its f32 ones here, the
# port's 0.117-0.436, and the two 0.112-0.405 apart (dales, kitti360,
# scannet). The loss stays within one bf16 rounding (2^-8; read 9e-4 to
# 2.2e-3). A 1% error in one attention gradient moves these gradients by
# less than the rounding does (`tools/spt3_bf16_step_cuda.py`), so this
# is a gross check; the f32 step above carries the fine one.
TOL_BF16_STEP = dict(loss=2.0 ** -8, grads=0.5)
EXPERIMENTS = {'dales': 'semantic/dales', 'kitti360': 'semantic/kitti360',
               'scannet': 'panoptic/scannet'}


def _raw(tmp_path, name, seed):
    """A raw file of `name` written by the port, and its reader pair
    (port, JAX) with the experiment's options."""
    if name == 'scannet':
        path = str(tmp_path / f'scene{seed:04d}_00')
        tsyn.write_scannet_scan(path, tsyn.synthetic_room_cloud(
            seed=seed, n_points=POINTS))
        return path, (tscannet.read_scannet_scan,
                      jscannet.read_scannet_scan), {'instances': True}
    cloud, planted = tsyn.synthetic_aerial_cloud(seed=seed, n_points=POINTS)
    cloud['planted'] = planted
    path = str(tmp_path / f'{name}_{seed}.ply')
    if name == 'dales':
        tsyn.write_dales_tile(path, cloud)
        return path, (tdales.read_dales_tile, jdales.read_dales_tile), {}
    tsyn.write_kitti360_window(path, cloud)
    return path, (tkitti.read_kitti360_window,
                  jkitti.read_kitti360_window), {}


@pytest.fixture(scope='module', params=sorted(EXPERIMENTS))
def case(request, tmp_path_factory):
    """(name, JAX config, port config, JAX batch): two clouds of the
    dataset through each package's reader, preprocessing and batch
    preparation (eval mode, no sampling); the batches must be equal."""
    name = request.param
    argv = [f'experiment={EXPERIMENTS[name]}'] + NARROW
    jcfg, cfg = jload(CONFIGS, 'train', argv), load_config(CONFIGS, 'train',
                                                           argv)
    pre = texp._pre_transform_config(cfg)
    assert repr(sorted(pre.items())) == repr(sorted(
        jexp._pre_transform_config(jcfg).items()))
    tmp = tmp_path_factory.mktemp(name)
    nags = {'jax': [], 'port': []}
    n_cls = int(cfg['datamodule']['num_classes'])
    for seed in (0, 1):
        path, (read, jread), kw = _raw(tmp, name, seed)
        nags['jax'].append(jpre.preprocess_cloud(
            jread(path, **kw), num_classes=n_cls, **pre))
        nags['port'].append(tpre.preprocess_cloud(
            read(path, **kw), num_classes=n_cls, **pre))
    assert all(n.num_levels == 4 for n in nags['port'])
    over = dict(sample_graph_r=-1, sample_segment_ratio=0)
    ref = jprep.prepare_batch(nags['jax'], dataclasses.replace(
        jexp.build_batch_config(jcfg), **over), train=False, device=False)
    got = tprep.prepare_batch(nags['port'], dataclasses.replace(
        texp.build_batch_config(cfg), **over), train=False)
    assert_padded_equal(got, ref)
    assert len(ref.levels) == 4
    if name == 'scannet':
        # the ceiling's vertices (object -1) came through the instance
        # pipeline: the level-1 instance graph has edges and targets
        assert ref.levels[1].obj_edge_mask.sum() > 0
    return name, jcfg, cfg, ref


def _models(jcfg, cfg, batch, compute_dtype=None):
    """The JAX model with random parameters, and the port's with them."""
    n_cls = int(cfg['datamodule']['num_classes'])
    jnet = jexp.build_model(jcfg, num_graphs=2, compute_dtype=compute_dtype)
    net = texp.build_model(cfg, num_graphs=2, compute_dtype=compute_dtype,
                           device='cpu')
    assert len(net.down_dim) == 3 and len(net.up_dim) == 2
    assert net.num_down_stages == 3 and not net.nano
    panoptic = str(cfg['model'].get('task', 'semantic')) == 'panoptic'
    if panoptic:
        jmodel = jpan.PanopticSegmentationModel(net=jnet, num_classes=n_cls)
        model = tpan.PanopticSegmentationModel(net, n_cls)
    else:
        jmodel, model = JModel(net=jnet, num_classes=n_cls), TModel(net,
                                                                    n_cls)
    params = _params(jmodel, batch)
    load_jax_params(model, params)
    return jmodel, model.eval(), params, panoptic


def test_spt3_forward_matches_jax(case):
    name, jcfg, cfg, batch = case
    jmodel, model, params, panoptic = _models(jcfg, cfg, batch)
    ref = jax.jit(lambda p, b: jmodel.apply({'params': p}, b, train=False))(
        params, batch)
    with torch.no_grad():
        got = model(from_numpy(batch, 'cpu', None))
    if panoptic:
        (ref, ref_ea), (got, ea) = ref, got
        em = np.asarray(batch.levels[1].obj_edge_mask)
        np.testing.assert_allclose(ea.numpy()[em], np.asarray(ref_ea)[em],
                                   **TOL_F32)
    assert len(got) == len(ref) == 3
    for lvl, g, r in zip(batch.levels[1:], got, ref):
        m = np.asarray(lvl.node_mask)
        assert m.sum() > 0
        np.testing.assert_allclose(g.numpy()[m], np.asarray(r)[m],
                                   **TOL_F32)


@pytest.mark.parametrize('case', ['dales'], indirect=True)
def test_spt3_bf16_forward_matches_jax(case):
    name, jcfg, cfg, batch = case
    jmodel, model, params, _ = _models(jcfg, cfg, batch, 'bfloat16')
    ref = jax.jit(lambda p, b: jmodel.apply({'params': p}, b, train=False))(
        params, batch)
    with torch.no_grad():
        got = model(from_numpy(batch, 'cpu', 'bfloat16'))
    for lvl, g, r in zip(batch.levels[1:], got, ref):
        m = np.asarray(lvl.node_mask)
        g, r = g.float().numpy()[m], np.asarray(r, np.float32)[m]
        assert np.isfinite(g).all()
        np.testing.assert_allclose(g, r, **TOL_BF16)
        assert np.abs(g - r).mean() < MEAN_ABS_BF16
        assert (g.argmax(1) == r.argmax(1)).mean() >= ARGMAX_AGREEMENT_BF16


@pytest.fixture(scope='module')
def jax_step(case):
    """(parameters, step): random JAX parameters of the case's task and
    `step(precision)`, the JAX task's loss and gradients (by port key) at
    them, its config built with `trainer.precision=<precision>` (32 or
    bf16); each precision computed once."""
    name, _, _, batch = case
    argv = [f'experiment={EXPERIMENTS[name]}'] + NARROW
    params = _params(jexp.build_task(jload(CONFIGS, 'train', argv),
                                     num_graphs=2).model, batch)

    @functools.lru_cache(maxsize=None)
    def step(precision):
        jtask = jexp.build_task(jload(CONFIGS, 'train', argv + [
            f'trainer.precision={precision}']), num_graphs=2)
        loss, grads = jax.jit(jax.value_and_grad(
            lambda p: jtask._loss_fn(p, batch, jax.random.PRNGKey(0))[0]))(
            params)
        return jtask, float(loss), _flat(grads)

    return params, step


def test_spt3_train_step_matches_jax(case, jax_step):
    name, jcfg, cfg, batch = case
    params, step = jax_step
    jtask, loss, grads = step('32')
    task = texp.build_task(cfg, num_graphs=2, device='cpu')
    assert type(task).__name__ == type(jtask).__name__
    assert task.lambdas == tuple(jtask.multi_stage_loss_lambdas) == (1., 50.)
    load_jax_params(task.model, params)
    tb = from_numpy(batch, 'cpu', None, train=True)
    task.model.train()
    got, _ = task.loss(tb)
    got.backward()
    np.testing.assert_allclose(got.item(), loss, rtol=TOL_STEP['loss'])
    named = dict(task.model.named_parameters())
    assert set(named) == set(grads)
    # levels 1 and 2 are supervised: the level-3 head learns nothing
    head3 = [k for k in named if k.startswith('head_2.')]
    assert head3 and all(named[k].grad is None for k in head3)
    assert all(not grads[k].any() for k in head3)
    for key, p in named.items():
        if key in head3:
            continue
        g = grads[key]
        scale = max(float(np.abs(g).max()), 1e-6)
        err = float(np.abs(p.grad.numpy() - g).max())
        assert err <= TOL_STEP['rel'] * scale, \
            f'{key}: gradient max err {err:.3e} vs |ref| {scale:.3e}'
    # a step moves every parameter with a gradient
    before = {k: p.detach().clone() for k, p in named.items()}
    out = task.train_step(tb)
    assert torch.isfinite(out['loss'])
    assert all(not torch.equal(before[k], p.detach())
               for k, p in named.items() if p.grad is not None
               and bool(p.grad.any()))


def test_spt3_bf16_train_step_matches_jax(case, jax_step):
    """The port's bf16 step against JAX's bf16 step from the same
    parameters, at TOL_BF16_STEP. On the CPU the port's attention is the
    plain forward with K1's closed-form backward: the card's route but
    for the kernel's own forward."""
    name, _, cfg, batch = case
    params, step = jax_step
    _, ref_loss, ref = step('32')
    _, jax_loss, jax_grads = step('bf16')
    bcfg = load_config(CONFIGS, 'train', [f'experiment={EXPERIMENTS[name]}']
                       + NARROW + ['trainer.precision=bf16'])
    task = texp.build_task(bcfg, num_graphs=2, device='cpu')
    assert task.model.net.compute_dtype == 'bfloat16'
    load_jax_params(task.model, params)
    task.model.train()
    got, _ = task.loss(from_numpy(batch, 'cpu', 'bfloat16', train=True))
    got.backward()
    named = dict(task.model.named_parameters())
    assert set(named) == set(ref)

    def flat(g):
        return np.concatenate([np.ravel(g[k]) for k in sorted(ref)])

    grads = flat({k: (p.grad.float().numpy() if p.grad is not None
                      else np.zeros(p.shape, np.float32))
                  for k, p in named.items()})
    loss_err = abs(got.item() - jax_loss) / abs(jax_loss)
    grad_err = _rel_l2(grads, flat(jax_grads))
    print(f'{name}: bf16 step, port vs JAX: loss rel {loss_err:.3e}, '
          f'gradients rel L2 {grad_err:.3g}; from JAX f32: port '
          f'{_rel_l2(grads, flat(ref)):.3g}, JAX bf16 '
          f'{_rel_l2(flat(jax_grads), flat(ref)):.3g}')
    assert np.isfinite(grads).all()
    assert loss_err <= TOL_BF16_STEP['loss']
    assert grad_err <= TOL_BF16_STEP['grads']
