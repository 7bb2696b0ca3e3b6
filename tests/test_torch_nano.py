"""Nano SPT (`experiment=semantic/s3dis_nano`, `panoptic/s3dis_nano`:
no level 0, the first stage a transformer `Stage` on level 1) in the
port vs the JAX package, on the CPU: the nano-2 forward at its full
width (32 channels, 8 heads) in f32, its training step's loss and
gradients (the transpose tables on both sides), the panoptic nano
forward, a narrow nano-3 (three down stages on a 4-level NAG), and the
`train` / `eval` entry points on a tiny S3DIS tree. Weights come across
through `utils/jax_params.py`; the JAX model takes its XLA attention on
the CPU, the port the kernels' plain versions."""
import dataclasses
import os.path as osp

import numpy as np
import pytest
import torch

import jax

from superpoint_transformer_tpu import experiment as jexp
from superpoint_transformer_tpu import inference as jinf
from superpoint_transformer_tpu.config.loader import load_config as jload
from superpoint_transformer_tpu.data.csr import Cluster as JCluster
from superpoint_transformer_tpu.data.data import Data as JData
from superpoint_transformer_tpu.data.nag import NAG as JNAG
from superpoint_transformer_tpu.models import panoptic as jpan
from superpoint_transformer_tpu.models.semantic import (
    SemanticSegmentationModel as JModel, SemanticTask as JTask)
from superpoint_transformer_tpu.transforms import prepare_batch
from superpoint_transformer_tpu.transforms.preprocess import (
    preprocess_cloud as jpreprocess)
from superpoint_transformer_tpu.utils.synthetic import (
    random_nag, synthetic_room_cloud as jroom)
from superpoint_transformer_torch import eval as teval
from superpoint_transformer_torch import inference as tinf
from superpoint_transformer_torch import train as ttrain
from superpoint_transformer_torch.config.loader import load_config
from superpoint_transformer_torch.data.padded import from_numpy
from superpoint_transformer_torch.experiment import (build_batch_config,
                                                     build_model)
from superpoint_transformer_torch.models import panoptic as tpan
from superpoint_transformer_torch.models.semantic import (
    SemanticSegmentationModel as TModel, SemanticTask)
from superpoint_transformer_torch.transforms.preprocess import (
    preprocess_cloud as tpreprocess)
from superpoint_transformer_torch.utils.jax_params import load_jax_params
from superpoint_transformer_torch.utils.synthetic import (
    synthetic_room_cloud as troom)
from tests.test_torch_train import HPARAMS, _flat, _params
from tests.test_torch_train import TOL_F32 as TOL_STEP
from tests.test_torch_cli import _argv
from tests.test_datasets import make_raw_s3dis
from tests.test_torch_host_path import PRE, ROOM_POINTS

# f32 logits through the whole network (test_torch_spt.py's tolerance)
TOL_F32 = dict(rtol=1e-4, atol=1e-4)
F32 = ['trainer.precision=32']
# nano-3 is nano-2's config at spt-3's depth (3 down, 2 up stages); here
# narrowed to 16 channels, 4 heads, one block a stage
NANO3_NARROW = ['model._down_dim=[16,16,16]', 'model._up_dim=[16,16]',
                'model.net.down_num_heads=4', 'model.net.up_num_heads=4',
                'model.net.down_num_blocks=1']


def _cfgs(experiment, extra=()):
    argv = [f'experiment={experiment}'] + F32 + list(extra)
    return jload(ttrain.CONFIG_DIR, 'train', argv), \
        load_config(ttrain.CONFIG_DIR, 'train', argv)


def _segment_features(levels, names, seed):
    """The stored per-segment features of a nano NAG (its datasets load
    them with low=1), drawn with numpy."""
    rng = np.random.default_rng(seed)
    for d in levels:
        for k in names:
            d[k] = rng.random((d.num_nodes, 3 if k.endswith('rgb')
                               else 1)).astype(np.float32)


def _nano_batch(jcfg, with_instances=False, four_levels=False):
    """A 2-graph nano batch (start_i_level 1) of the JAX host path, with
    the label histograms and the transpose tables."""
    bcfg = dataclasses.replace(jexp.build_batch_config(jcfg),
                               sample_graph_r=-1, sample_segment_ratio=0)
    if with_instances:
        bcfg = dataclasses.replace(bcfg, instance_radius=10.0)
    nags = []
    for seed in (0, 1):
        nag = random_nag(seed=seed, n_points=512,
                         with_instances=with_instances)
        levels = [nag[1], nag[2]]
        if four_levels:
            levels.append(_level3(nag[2], seed))
        _segment_features(levels, bcfg.segment_hf, seed)
        nags.append(JNAG(levels, start_i_level=1))
    batch = prepare_batch(nags, bcfg, train=False, device=False)
    assert batch.start_i_level == 1
    assert batch.levels[0].nbr_in_idx is not None
    return batch


def _level3(d2, seed, n3=4):
    """A level above random_nag's level 2: n3 parents of its nodes, all
    pairs of them as edges, the fields of random_nag's levels."""
    rng = np.random.default_rng(100 + seed)
    n2 = d2.num_nodes
    sup = np.concatenate([np.arange(n3), rng.integers(0, n3, n2 - n3)])
    d2['super_index'] = sup
    cnt = np.bincount(sup, minlength=n3)
    pos = np.stack([np.bincount(sup, d2.pos[:, i], minlength=n3)
                    for i in range(3)], 1) / cnt[:, None]
    s, t = np.triu_indices(n3, 1)
    y = np.zeros((n3, 14), np.int64)
    y[np.arange(n3), rng.integers(0, 13, n3)] = cnt
    normal = rng.normal(size=(n3, 3))
    return JData(
        pos=pos.astype(np.float32),
        sub=JCluster(sup, np.arange(n2), dense=True),
        edge_index=np.stack([s, t]),
        edge_attr=rng.normal(size=(s.shape[0], 7)).astype(np.float32),
        y=y, normal=(normal / np.linalg.norm(normal, axis=1,
                                             keepdims=True)).astype(
            np.float32),
        **{k: rng.random((n3, 1)).astype(np.float32) for k in (
            'log_length', 'log_surface', 'log_volume', 'log_size')})


def _assert_logits(got, ref, masks):
    assert len(got) == len(ref)
    for g, r, m in zip(got, ref, masks):
        m = np.asarray(m)
        np.testing.assert_allclose(g.detach().numpy()[m], np.asarray(r)[m],
                                   **TOL_F32)


@pytest.fixture(scope='module')
def nano2():
    jcfg, cfg = _cfgs('semantic/s3dis_nano')
    batch = _nano_batch(jcfg)
    jnet = jexp.build_model(jcfg, num_graphs=2)
    assert jnet.nano and jnet.point_mlp is None
    params = _params(JModel(net=jnet, num_classes=13), batch)
    return jcfg, cfg, batch, jnet, params


def test_nano2_forward_matches_jax(nano2):
    jcfg, cfg, batch, jnet, params = nano2
    ref = JModel(net=jnet, num_classes=13).apply({'params': params}, batch,
                                                 train=False)
    net = build_model(cfg, num_graphs=2, device='cpu')
    assert net.nano and net.num_down_stages == 1
    assert net.first_stage.num_blocks == 3
    assert net.first_stage.block_0.sa.num_heads == 8
    # full width: in_mlp from the node injection (pos, parent diameter,
    # the 8 stored segment means: 5 geometric features and rgb) to 32
    assert net.first_stage.in_mlp.dims == [3 + 1 + 8, 32, 32]
    model = TModel(net, 13)
    load_jax_params(model, params)
    model.eval()
    with torch.no_grad():
        got = model(from_numpy(batch, 'cpu', None))
    _assert_logits(got, ref, [lvl.node_mask for lvl in batch.levels])


def test_nano2_train_step_matches_jax(nano2):
    jcfg, cfg, batch, jnet, params = nano2
    jtask = JTask(net=jnet, num_classes=13, **HPARAMS)
    loss, grads = jax.jit(jax.value_and_grad(
        lambda p: jtask._loss_fn(p, batch, jax.random.PRNGKey(0))[0]))(
        params)
    grads = _flat(grads)
    task = SemanticTask(build_model(cfg, num_graphs=2, device='cpu'),
                        num_classes=13, **HPARAMS)
    load_jax_params(task.model, params)
    tb = from_numpy(batch, 'cpu', None, train=True)
    assert tb[1].nbr_in_idx is not None
    task.model.train()
    got, _ = task.loss(tb)
    got.backward()
    np.testing.assert_allclose(got.item(), float(loss),
                               rtol=TOL_STEP['loss'])
    named = dict(task.model.named_parameters())
    assert set(named) == set(grads)
    for key, p in named.items():
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


def test_panoptic_nano_forward_matches_jax():
    jcfg, cfg = _cfgs('panoptic/s3dis_nano')
    batch = _nano_batch(jcfg, with_instances=True)
    assert batch.levels[0].obj_edge_index is not None
    jmodel = jpan.PanopticSegmentationModel(
        net=jexp.build_model(jcfg, num_graphs=2), num_classes=13)
    params = _params(jmodel, batch)
    ref, ref_ea = jmodel.apply({'params': params}, batch, train=False)
    model = tpan.PanopticSegmentationModel(
        build_model(cfg, num_graphs=2, device='cpu'), 13)
    load_jax_params(model, params)
    model.eval()
    with torch.no_grad():
        got, ea = model(from_numpy(batch, 'cpu', None))
    _assert_logits(got, ref, [lvl.node_mask for lvl in batch.levels])
    em = np.asarray(batch.levels[0].obj_edge_mask)
    assert em.sum() > 0
    np.testing.assert_allclose(ea.numpy()[em], np.asarray(ref_ea)[em],
                               **TOL_F32)


def test_nano3_narrow_build_and_forward_match_jax():
    jcfg, cfg = _cfgs('semantic/s3dis_nano', NANO3_NARROW)
    batch = _nano_batch(jcfg, four_levels=True)
    assert len(batch.levels) == 3
    jnet = jexp.build_model(jcfg, num_graphs=2)
    net = build_model(cfg, num_graphs=2, device='cpu')
    assert net.nano and net.num_down_stages == 2 and len(net.up_dim) == 2
    jmodel = JModel(net=jnet, num_classes=13)
    params = _params(jmodel, batch)
    ref = jmodel.apply({'params': params}, batch, train=False)
    model = TModel(net, 13)
    load_jax_params(model, params)
    model.eval()
    with torch.no_grad():
        got = model(from_numpy(batch, 'cpu', None))
    assert len(got) == 3
    _assert_logits(got, ref, [lvl.node_mask for lvl in batch.levels])


def test_nano_infer_nag_and_e2e_inference(nano2):
    """A preprocessed room (with the nano datamodule's segment means)
    served without level 0: `infer_nag`'s level-1 logits vs the JAX
    `infer_nag` on the same NAG, and `e2e_inference` with the nano batch
    config labels every raw point with its level-1 prediction."""
    jcfg, cfg, _, jnet, params = nano2
    pre = dict(PRE, segment_mean_hf=tuple(
        cfg['datamodule']['segment_mean_hf']))
    raw = troom(seed=0, n_points=ROOM_POINTS)
    jnag = jpreprocess(jroom(seed=0, n_points=ROOM_POINTS), **pre)
    tnag = tpreprocess(raw.clone(), **pre)
    jbcfg = dataclasses.replace(jexp.build_batch_config(jcfg),
                                **jinf.EVAL_BATCH_OVERRIDES)
    bcfg = dataclasses.replace(build_batch_config(cfg),
                               **tinf.EVAL_BATCH_OVERRIDES)
    assert bcfg.nano and jbcfg.nano
    ref = jinf.infer_nag(JModel(net=jnet, num_classes=13),
                         {'params': params},
                         JNAG([jnag[i] for i in jnag.levels[1:]],
                              start_i_level=1), jbcfg,
                         fetch='logits')
    model = TModel(build_model(cfg, num_graphs=1, device='cpu'), 13)
    load_jax_params(model, params).eval()
    nano = tinf.without_level0(tnag)
    assert nano.start_i_level == 1 and nano[1] is tnag[1]
    got = tinf.infer_nag(model, nano, bcfg, fetch='logits')
    assert got.shape == (tnag[1].num_nodes, 13)
    np.testing.assert_allclose(got, ref, **TOL_F32)
    pred, info = tinf.e2e_inference(model, raw.clone(), pre_cfg=pre,
                                    batch_cfg=bcfg, tiling=(1, 1),
                                    warmup=False)
    assert info['n_tiles'] == 1 and pred.shape == (raw.num_nodes,)
    voxel = got.argmax(1)[tnag[0].super_index]
    full = np.empty(tnag[0].sub.num_items, np.int64)
    full[tnag[0].sub.points] = np.repeat(voxel, tnag[0].sub.sizes)
    np.testing.assert_array_equal(pred, full)


def test_nano_rejects_a_nag_with_level0(nano2):
    _, cfg, _, _, _ = nano2
    from superpoint_transformer_torch.utils.synthetic import (
        random_padded_nag)
    net = build_model(cfg, num_graphs=2, device='cpu')
    with pytest.raises(ValueError, match='start level'):
        net(from_numpy(random_padded_nag(seed=0), 'cpu', None))


def test_train_then_eval_nano_cli(tmp_path):
    """`train.main` / `eval.main` with experiment=semantic/s3dis_nano on
    the CPU (tests/test_cli.py's nano recipe): the datasets load the
    NAGs without level 0, the nano model trains, and the evaluation of
    its checkpoint reports finite metrics over the test mass."""
    root = str(tmp_path / 's3dis')
    make_raw_s3dis(root)
    out = str(tmp_path / 'out')
    argv = _argv(root, out, 'semantic/s3dis_nano')
    argv = [a for a in argv if not a.startswith(('model._point_mlp',
                                                 'model._down_dim',
                                                 'model._up_dim'))]
    best = ttrain.main(argv)
    assert np.isfinite(best)
    ckpt = osp.join(out, 'checkpoints', 'last')
    state = torch.load(osp.join(ckpt, 'state.pt'), weights_only=True)
    assert any(k.startswith('net.first_stage.block_')
               for k in state['model'])
    m = teval.main(argv + [f'ckpt_path={ckpt}'])
    assert np.isfinite(m['miou']) and m['confmat'].sum() > 0
