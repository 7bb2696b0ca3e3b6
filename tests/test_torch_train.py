"""The port's training slice vs the JAX package: a narrow SPT trained by
`SemanticTask` on the same batch (the JAX host path's, label histograms
kept) from the same weights, in f32 and bf16. Checked: the ce_kl loss,
every parameter gradient, the LR of each optimizer group at each step,
the parameter updates of 3 AdamW steps, the group labels, the confusion
matrix and `eval_step`; plus the losses, the schedule, the dropout
rates and `build_task` on their own.

On the CPU the JAX model takes its XLA attention path (the Pallas
kernels need a non-CPU backend); the port runs K1's plain version and
closed-form backward, whose math test_torch_attention.py pins to the
Pallas kernel."""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from superpoint_transformer_tpu.loss import semantic as jloss
from superpoint_transformer_tpu.metrics.semantic import (
    confusion_matrix_from_histogram as jconfmat)
from superpoint_transformer_tpu.models.semantic import (
    SemanticTask as JTask, TrainState)
from superpoint_transformer_tpu.models.spt import SPT as JSPT
from superpoint_transformer_tpu.optim.lr_scheduler import (
    _is_transformer_param, cosine_with_warmup as jcosine, make_optimizer)
from superpoint_transformer_tpu.transforms import BatchConfig, prepare_batch
from superpoint_transformer_tpu.utils.synthetic import random_nag
from superpoint_transformer_torch.data.padded import from_numpy
from superpoint_transformer_torch.experiment import (FLAGSHIP_CFG,
                                                     build_task)
from superpoint_transformer_torch.loss import semantic as tloss
from superpoint_transformer_torch.metrics.semantic import (
    confusion_matrix_from_histogram as tconfmat)
from superpoint_transformer_torch.models.semantic import SemanticTask
from superpoint_transformer_torch.models.spt import SPT as TSPT
from superpoint_transformer_torch.optim.lr_scheduler import (
    cosine_with_warmup as tcosine)
from superpoint_transformer_torch.utils.jax_params import (jax_key_for,
                                                           load_jax_params)

# the narrow SPT of test_torch_spt.py: H*D = 16 != C = 32
NARROW = dict(point_mlp=(12, 16, 32), down_dim=(32, 32),
              down_in_mlp=((36, 32, 32), (36, 32, 32)), down_num_heads=4,
              down_num_blocks=2, up_dim=(32,), up_in_mlp=((68, 32, 32),),
              up_num_heads=4, up_num_blocks=1, h_edge_mlp=(18, 16, 16),
              in_rpe_dim=16, qk_dim=4, num_graphs=2)
# the flagship's weight decay and attention LR scale; a peak LR of 1e-3
# reached after a 2-step warm-up, so that steps 1 and 2 update by ~lr
# (step 0 runs at the warm-up start, 1e-6). At the flagship's 0.1 the
# random-weight network is chaotic: 3 steps of 0.1 carry a 1e-4 gradient
# difference into parameter differences of the size of the steps.
HPARAMS = dict(lr=1e-3, weight_decay=1e-2, transformer_lr_scale=0.1,
               total_steps=10, warmup_steps=2)
STEPS = 3
# f32: the same math in another summation order, through ~20 layers and
# back (the loss is ~200, logits agree to 1e-4 in test_torch_spt.py).
# Gradients and logits are compared relative to each tensor's largest
# entry. Adam
# divides each entry's step by that entry's gradient RMS, so an entry
# whose gradient is small or changes sign carries the relative gradient
# error into its step at full size: each tensor's total update is
# compared in L2 (measured <= 4.3e-3).
TOL_F32 = dict(loss=1e-4, rel=1e-4, update=1e-2)
# bf16 compute rounds to 2^-8 after every op, at other points in PyTorch
# (after every op) than in XLA:CPU (at fusion boundaries), and K1 keeps
# f32 softmax weights where the JAX XLA attention rounds them to bf16.
# GraphNorm's backward on random weights amplifies that: JAX's own bf16
# gradients are 30-75% (L2) from its f32 ones in the early layers. So
# the port in bf16 is held to the f32 result as closely as JAX in bf16
# is, within BF16_RATIO, over the loss, the gradients and the updates
# (each a mean over tensors of the relative L2 error).
BF16_RATIO = 1.5


@pytest.fixture(scope='module')
def batch():
    """A 2-graph batch from the JAX host path, with label histograms."""
    nags = [random_nag(seed=0), random_nag(seed=1)]
    cfg = BatchConfig(sample_graph_r=-1, sample_segment_ratio=0)
    b = prepare_batch(nags, cfg, train=False, device=False)
    assert b.levels[1].y is not None and b.levels[2].y is not None
    return b


def _params(model, batch):
    """Random flax params drawn with numpy over the `eval_shape` tree."""
    shapes = jax.eval_shape(lambda: model.init(
        jax.random.PRNGKey(0), batch, train=False))['params']
    rng = np.random.default_rng(0)

    def draw(path, leaf):
        name = path[-1].key
        r = rng.standard_normal(leaf.shape).astype(np.float32)
        if name == 'kernel':
            return r / np.float32(np.sqrt(leaf.shape[0]))
        return r * np.float32(0.1) + np.float32(name in ('weight',
                                                         'mean_scale'))

    return jax.tree_util.tree_map_with_path(draw, shapes)


def _flat(tree):
    """{state_dict key: numpy array} of a flax tree (kernels transposed
    to the Linear layout)."""
    out = {}
    for path, leaf in jax.tree_util.tree_leaves_with_path(tree):
        names = tuple(p.key for p in path)
        a = np.asarray(leaf, np.float32)
        out[jax_key_for(names)] = a.T if names[-1] == 'kernel' else a
    return out


def _jax_run(batch, compute_dtype):
    """The JAX task from the test's parameters: loss and gradients at
    them, then STEPS train steps."""
    task = JTask(net=JSPT(compute_dtype=compute_dtype, **NARROW),
                 num_classes=13, **HPARAMS)
    params = _params(task.model, batch)
    rng = jax.random.PRNGKey(0)
    loss, grads = jax.jit(jax.value_and_grad(
        lambda p: task._loss_fn(p, batch, rng)[0]))(params)
    params = jax.tree_util.tree_map(np.array, params)   # host copies
    state = TrainState.create(
        apply_fn=task.model.apply, params=params,
        tx=make_optimizer(lr=task.lr, weight_decay=task.weight_decay,
                          transformer_lr_scale=task.transformer_lr_scale,
                          total_steps=task.total_steps,
                          num_warmup_steps=task.warmup_steps,
                          params=params))
    ev = {k: np.asarray(v) for k, v in task.eval_step(state, batch).items()}
    losses, cms = [], []
    for _ in range(STEPS):
        state, metrics = task.train_step(state, batch, rng)
        losses.append(float(metrics['loss']))
        cms.append(np.asarray(metrics['confmat']))
    return dict(params=params, loss=float(loss), grads=_flat(grads),
                eval=ev, losses=losses, cms=cms, final=_flat(state.params))


@pytest.fixture(scope='module')
def jax_runs(batch):
    return {cd: _jax_run(batch, cd) for cd in (None, 'bfloat16')}


def _port_run(batch, compute_dtype, params):
    """The same through the port's `SemanticTask`, checking on the way
    that the optimizer groups are JAX's labels and that each group's LR
    at each step is JAX's schedule."""
    task = SemanticTask(TSPT(compute_dtype=compute_dtype, **NARROW),
                        num_classes=13, **HPARAMS)
    load_jax_params(task.model, params)
    tb = from_numpy(batch, 'cpu', compute_dtype, train=True)
    task.model.train()
    loss, _ = task.loss(tb)
    loss.backward()
    named = dict(task.model.named_parameters())
    grads = {k: p.grad.numpy().copy() for k, p in named.items()}
    ev = {k: v.numpy() for k, v in task.eval_step(tb).items()}

    labels = {jax_key_for(tuple(q.key for q in path)):
              _is_transformer_param(path) for path, _ in
              jax.tree_util.tree_leaves_with_path(params)}
    groups = {id(p): g['name'] for g in task.optimizer.param_groups
              for p in g['params']}
    assert set(named) == set(labels)
    for key, p in named.items():
        assert (groups[id(p)] == 'transformer') == labels[key], key

    schedules = {'base': jcosine(HPARAMS['lr'], HPARAMS['total_steps'],
                                 HPARAMS['warmup_steps']),
                 'transformer': jcosine(
                     HPARAMS['lr'] * HPARAMS['transformer_lr_scale'],
                     HPARAMS['total_steps'], HPARAMS['warmup_steps'])}
    losses, cms = [], []
    for step in range(STEPS):
        metrics = task.train_step(tb)
        losses.append(metrics['loss'].item())
        cms.append(metrics['confmat'].numpy())
        for g in task.optimizer.param_groups:
            np.testing.assert_allclose(g['lr'],
                                       float(schedules[g['name']](step)),
                                       rtol=1e-6)
        assert task.lr_at(step) == task.optimizer.param_groups[0]['lr']
    assert task.step == STEPS
    assert [g['lr'] for g in task.optimizer.param_groups] == \
        [HPARAMS['lr'], HPARAMS['lr'] * HPARAMS['transformer_lr_scale']]
    return dict(loss=loss.item(), grads=grads, eval=ev, losses=losses,
                cms=cms,
                final={k: p.detach().numpy() for k, p in named.items()})


def _rel_l2(a, b):
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-12))


def _mean_rel(got, ref):
    return float(np.mean([_rel_l2(got[k], ref[k]) for k in ref]))


def _updates(run, start):
    return {k: run['final'][k] - start[k] for k in start}


def _check_confmats(batch, got, ref, exact):
    valid = np.asarray(batch.levels[1].node_mask)
    mass = np.asarray(batch.levels[1].y)[valid][:, :13].sum()
    for a, b in zip(got, ref):
        assert a.dtype == np.int64 and a.sum() == b.sum() == mass
        if exact:
            np.testing.assert_array_equal(a, b)


def test_train_steps_match_jax_semantic_task_f32(batch, jax_runs):
    ref = jax_runs[None]
    got = _port_run(batch, None, ref['params'])
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
    _check_confmats(batch, got['cms'], ref['cms'], exact=True)

    # eval_step at the initial parameters: the inference route (K2)
    ev, ref_ev = got['eval'], ref['eval']
    np.testing.assert_allclose(ev['loss'], ref_ev['loss'],
                               rtol=TOL_F32['loss'])
    valid = np.asarray(batch.levels[1].node_mask)
    logits, ref_logits = (e['logits_level1'][valid] for e in (ev, ref_ev))
    err, scale = np.abs(logits - ref_logits).max(), np.abs(ref_logits).max()
    assert err <= TOL_F32['rel'] * scale, f'logits: {err:.3e} of {scale:.3e}'
    _check_confmats(batch, [ev['confmat']], [ref_ev['confmat']], exact=True)


def test_train_steps_match_jax_semantic_task_bf16(batch, jax_runs):
    f32, jb = jax_runs[None], jax_runs['bfloat16']
    got = _port_run(batch, 'bfloat16', jb['params'])
    start = _flat(f32['params'])
    # (port bf16 vs JAX f32, JAX bf16 vs JAX f32) for each quantity
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
    for name, (port, jax_bf16) in pairs.items():
        print(f'{name}: port bf16 {port:.4g}, JAX bf16 {jax_bf16:.4g} '
              'from JAX f32')
        assert port <= BF16_RATIO * jax_bf16, name
    _check_confmats(batch, got['cms'], jb['cms'], exact=False)


def test_confusion_matrix_matches_jax():
    rng = np.random.default_rng(0)
    logits = rng.standard_normal((300, 13)).astype(np.float32)
    y = rng.integers(0, 20, (300, 14)).astype(np.float32)
    mask = rng.random(300) < 0.8
    ref = np.asarray(jconfmat(jnp.asarray(logits), jnp.asarray(y), 13,
                              node_mask=jnp.asarray(mask)))
    got = tconfmat(torch.from_numpy(logits), torch.from_numpy(y), 13,
                   node_mask=torch.from_numpy(mask))
    assert got.dtype == torch.int64
    np.testing.assert_array_equal(got.numpy(), ref)


@pytest.mark.parametrize('loss_type', ['ce', 'wce', 'kl', 'ce_kl',
                                       'wce_kl'])
@pytest.mark.parametrize('weighted', [False, True])
def test_multi_stage_loss_matches_jax(loss_type, weighted):
    rng = np.random.default_rng(1)
    logits = [rng.standard_normal((n, 13)).astype(np.float32)
              for n in (200, 60)]
    hists = [rng.integers(0, 5, (n, 14)).astype(np.float32)
             for n in (200, 60)]
    hists[0][:10] = 0                     # rows with no label at all
    hists[0][10:20, 13] = 50              # void-dominated rows
    masks = [rng.random(n) < 0.9 for n in (200, 60)]
    cw = rng.random(13).astype(np.float32) + 0.5 if weighted else None
    ref = jloss.multi_stage_loss(
        [jnp.asarray(a) for a in logits], [jnp.asarray(a) for a in hists],
        (1., 50.), loss_type=loss_type,
        class_weight=None if cw is None else jnp.asarray(cw),
        node_masks=[jnp.asarray(m) for m in masks])
    got = tloss.multi_stage_loss(
        [torch.from_numpy(a) for a in logits],
        [torch.from_numpy(a) for a in hists], (1., 50.),
        loss_type=loss_type,
        class_weight=None if cw is None else torch.from_numpy(cw),
        node_masks=[torch.from_numpy(m) for m in masks])
    np.testing.assert_allclose(got.item(), float(ref), rtol=1e-5)


@pytest.mark.parametrize('strategy', ['cos', 'linear'])
def test_cosine_with_warmup_matches_jax(strategy):
    ref = jcosine(0.1, 100, 20, warmup_strategy=strategy)
    got = tcosine(0.1, 100, 20, warmup_strategy=strategy)
    steps = [0, 1, 5, 19, 20, 21, 50, 99, 100, 150]
    # JAX evaluates in f32: at the end of the anneal 1 + cos cancels, so
    # its values there are off by ~1e-9 (1e-8 of the peak)
    np.testing.assert_allclose([got(s) for s in steps],
                               [float(ref(s)) for s in steps], rtol=1e-6,
                               atol=1e-8)


def test_build_task_reads_the_flagship_values():
    task = build_task(FLAGSHIP_CFG, num_graphs=2, total_steps=1000,
                      device='cpu')
    assert task.loss_type == 'ce_kl' and task.lambdas == (1.0, 50.0)
    (base, attn) = task.optimizer.param_groups
    assert (base['name'], attn['name']) == ('base', 'transformer')
    assert base['weight_decay'] == attn['weight_decay'] == 1e-2
    assert base['betas'] == (0.9, 0.999) and base['eps'] == 1e-8
    np.testing.assert_allclose(
        [s(20) for s in task.schedules], [0.1, 0.01], rtol=1e-12)
    np.testing.assert_allclose(
        [s(0) for s in task.schedules], [1e-6, 1e-6], rtol=1e-12)
    np.testing.assert_allclose(
        [s(1000) for s in task.schedules], [1e-6, 1e-6], rtol=1e-12)


@pytest.mark.parametrize('rate', ['point_drop', 'down_mlp_drop',
                                  'down_residual_drop', 'down_attn_drop',
                                  'down_drop_path', 'up_mlp_drop',
                                  'up_residual_drop', 'up_attn_drop',
                                  'up_drop_path'])
def test_dropout_and_drop_path_accept_only_none_or_zero(batch, rate):
    """Every dropout and DropPath rate builds; in evaluation a model with
    the rate set gives the outputs of the model at rate 0 (the same
    weights), and in training it drops (test_torch_variants.py holds the
    masks' statistics)."""
    zero = TSPT(**NARROW, **{rate: 0.0}).eval()
    some = TSPT(**NARROW, **{rate: 0.1}).eval()
    some.load_state_dict(zero.state_dict())
    tb = from_numpy(batch, 'cpu')
    with torch.no_grad():
        for a, b in zip(zero(tb), some(tb)):
            assert torch.equal(a, b)
        some.train()
        assert any(not torch.equal(a, b)
                   for a, b in zip(zero.train()(tb), some(tb)))
