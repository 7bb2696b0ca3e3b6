"""The port's Trainer vs the JAX package's, with the narrow SPT of
tests/test_torch_train.py in f32 and the same weights on both sides
(`load_jax_params`), on a room-level S3DIS of a few thousand points a
room (MiniS3DISRoom: 2 training rooms, 1 validation room).

Checked: two epochs of `fit` (train and validation losses per epoch
within TOL_F32['loss'], the validation predictions equal on every node
whose level-1 top-2 logit margin exceeds MARGIN, the CSV columns, the
tracked batches' keys); a checkpoint resume against a straight run
(bit-equal on the CPU); early stopping and the best checkpoint on a
scripted metric; the plateau controller and optimizer; gradient
accumulation against `optax.MultiSteps` (semantic and panoptic); the
test-time-augmented validation."""
import csv
import json
import os.path as osp

import numpy as np
import optax
import pytest
import torch

import jax

from superpoint_transformer_tpu import datasets as jds
from superpoint_transformer_tpu import trainer as jtrainer
from superpoint_transformer_tpu.models.panoptic import PanopticTask as JPan
from superpoint_transformer_tpu.models.semantic import (
    SemanticTask as JTask, TrainState)
from superpoint_transformer_tpu.models.spt import SPT as JSPT
from superpoint_transformer_tpu.optim import lr_scheduler as jsched
from superpoint_transformer_tpu.transforms import prepare as jprep
from superpoint_transformer_tpu.transforms import preprocess as jpre
from superpoint_transformer_tpu.utils import synthetic as jsyn
from superpoint_transformer_tpu.utils.synthetic import random_nag
from superpoint_transformer_torch import datasets as tds
from superpoint_transformer_torch import trainer as ttrainer
from superpoint_transformer_torch.data.padded import from_numpy
from superpoint_transformer_torch.models.panoptic import PanopticTask
from superpoint_transformer_torch.models.semantic import SemanticTask
from superpoint_transformer_torch.models.spt import SPT as TSPT
from superpoint_transformer_torch.optim import lr_scheduler as tsched
from superpoint_transformer_torch.transforms import prepare as tprep
from superpoint_transformer_torch.utils.jax_params import load_jax_params
from test_datasets import PRE_CFG, make_raw_s3dis
from test_torch_host_path import PRE
from test_torch_panoptic import _instances
from test_torch_train import (HPARAMS, NARROW, TOL_F32, _flat, _params,
                              _rel_l2)

# a node whose JAX level-1 logits' top-2 margin is above this has the
# same argmax on both sides (the clear-margin rule of
# tests/test_torch_host_path.py; the f32 logits agree to ~1e-5 here)
MARGIN = 1e-3
EPOCHS = 2
# the optimizer tests' schedule: no warm-up. At the warm-up's start
# (1e-6) an update moves O(1) parameters by a few f32 ulps, which the
# comparison of updates cannot resolve (tests/test_torch_train.py keeps
# the warm-up and compares the sum of 3 steps instead)
NO_WARMUP = dict(HPARAMS, warmup_steps=0)


@pytest.fixture(autouse=True, scope='module')
def one_torch_thread():
    """One intra-op thread while the module runs: the suite runs its
    files in parallel processes, where torch's default of a thread a core
    oversubscribes the CPU several times over (a test then takes 10-40x
    its time alone)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope='module')
def rooms(tmp_path_factory):
    """{stage: (port dataset, JAX dataset)} of MiniS3DISRoom on one
    JAX-processed root (the port reads the JAX cache)."""
    root = str(tmp_path_factory.mktemp('rooms'))
    make_raw_s3dis(root, rooms=2, n_per_obj=750)
    out = {}
    for stage in ('train', 'val', 'test'):
        kw = dict(fold=5, stage=stage, pre_transform_config=PRE_CFG)
        ref = jds.MiniS3DISRoom(root, **kw)
        ref.process()
        out[stage] = (tds.MiniS3DISRoom(root, **kw), ref)
    return out


@pytest.fixture(scope='module')
def caps(rooms):
    """(port training, port evaluation, JAX training, JAX evaluation)
    batch configs, with the capacities the train entry points pin."""
    train = [[rooms['train'][0][i]] for i in range(2)]
    val = [[rooms['val'][0][0]]]
    out = []
    for mod in (tprep, jprep):
        cfg = mod.BatchConfig()
        out += [mod.discover_caps(train, cfg,
                                  rng=np.random.default_rng(0)),
                mod.discover_caps(val, cfg, train=False, headroom_levels=0)]
    assert out[0].node_caps == out[2].node_caps
    assert out[1].node_caps == out[3].node_caps
    return out


@pytest.fixture(scope='module')
def params(caps, rooms):
    """The flax parameters of the narrow JAX task, drawn with numpy."""
    task = JTask(net=JSPT(**NARROW), num_classes=13, **HPARAMS)
    example = jprep.prepare_batch([rooms['val'][1][0]], caps[3],
                                  train=False, device=False)
    return _params(task.model, example)


def _jax_state(task, params, tx=None):
    params = jax.tree_util.tree_map(np.array, params)
    if tx is None:
        tx = jsched.make_optimizer(
            lr=task.lr, weight_decay=task.weight_decay,
            transformer_lr_scale=task.transformer_lr_scale,
            total_steps=task.total_steps,
            num_warmup_steps=task.warmup_steps, params=params)
    return TrainState.create(apply_fn=task.model.apply, params=params,
                             tx=tx)


def _port_task(params, cls=SemanticTask, **kw):
    task = cls(TSPT(**NARROW), num_classes=13, **dict(HPARAMS, **kw))
    load_jax_params(task.model, params)
    return task


def _csv(path):
    with open(path) as f:
        rows = list(csv.reader(f))
    return rows[0], [dict(zip(rows[0], r)) for r in rows[1:]]


@pytest.fixture(scope='module')
def fits(rooms, caps, params, tmp_path_factory):
    """EPOCHS of fit on each side, validating every epoch and tracking
    every validation batch."""
    out = {}
    for side in ('port', 'jax'):
        d = str(tmp_path_factory.mktemp(f'fit_{side}'))
        i = 0 if side == 'port' else 1
        mod = tds if side == 'port' else jds
        kw = dict(output_dir=d, max_epochs=EPOCHS,
                  check_val_every_n_epoch=1, seed=0, track_val_idx=-2)
        train = mod.DataLoader(rooms['train'][i], batch_size=1,
                               shuffle=True, seed=0)
        val = mod.DataLoader(rooms['val'][i], batch_size=1)
        if side == 'port':
            t = ttrainer.Trainer(_port_task(params), caps[0], caps[1], **kw)
            t.fit(train, val)
        else:
            task = JTask(net=JSPT(**NARROW), num_classes=13, **HPARAMS)
            t = jtrainer.Trainer(task, caps[2], caps[3], **kw)
            t.fit(_jax_state(task, params), train, val)
        out[side] = (d, t)
    return out


def test_fit_losses_and_columns_match_jax(fits):
    head, rows = _csv(osp.join(fits['port'][0], 'metrics.csv'))
    jhead, jrows = _csv(osp.join(fits['jax'][0], 'metrics.csv'))
    assert head == jhead
    assert [(r['epoch'], r['split']) for r in rows] == \
        [(r['epoch'], r['split']) for r in jrows] == \
        [(str(e), s) for e in range(EPOCHS) for s in ('train', 'val')]
    for r, j in zip(rows, jrows):
        np.testing.assert_allclose(float(r['loss']), float(j['loss']),
                                   rtol=TOL_F32['loss'])
        if r['split'] == 'train':
            np.testing.assert_allclose(float(r['lr']), float(j['lr']),
                                       rtol=1e-12)
    assert fits['port'][1].task.step == 2 * EPOCHS


def test_fit_validation_predictions_match_jax(fits):
    """Per epoch, the tracked validation batch: JAX's keys, and the same
    prediction on every clear-margin node."""
    for epoch in range(EPOCHS):
        name = f'val_e{epoch}_b0.npz'
        got = np.load(osp.join(fits['port'][0], 'predictions', name))
        ref = np.load(osp.join(fits['jax'][0], 'predictions', name))
        assert sorted(got.files) == sorted(ref.files) == \
            ['logits', 'pos', 'pred', 'y_hist']
        for k in ('pos', 'y_hist'):
            np.testing.assert_array_equal(got[k], ref[k])
        top2 = np.sort(ref['logits'], axis=1)[:, -2:]
        sure = top2[:, 1] - top2[:, 0] > MARGIN
        assert sure.mean() > 0.9
        np.testing.assert_array_equal(got['pred'][sure], ref['pred'][sure])


def _batches(rooms, cfg, n=2):
    return [from_numpy(tprep.prepare_batch(
        [rooms['train'][0][i % 2]], cfg, train=True,
        rng=np.random.default_rng(i)), 'cpu', train=True) for i in range(n)]


def test_resume_from_last_equals_a_straight_run(rooms, caps, params,
                                                tmp_path):
    """1 epoch, save, a fresh task loads 'last', 1 more epoch: the
    parameters, AdamW's moments and steps, and the step counts are those
    of 2 epochs straight, bit for bit."""
    batches = _batches(rooms, caps[0])
    straight = ttrainer.Trainer(_port_task(params), caps[0],
                                output_dir=str(tmp_path / 'a'),
                                max_epochs=2)
    straight.fit(batches)
    first = ttrainer.Trainer(_port_task(params), caps[0],
                             output_dir=str(tmp_path / 'b'), max_epochs=1)
    first.fit(batches)
    meta = json.load(open(tmp_path / 'b' / 'checkpoints' / 'last' /
                          'spt_meta.json'))
    assert set(meta) == {'version', 'epoch', 'best_miou', 'time'}
    assert meta['epoch'] == 1
    resumed = ttrainer.Trainer(_port_task(params), caps[0],
                               output_dir=str(tmp_path / 'b'), max_epochs=2)
    resumed.load_checkpoint('last')
    assert resumed.epoch == 1 and resumed.task.step == 2
    resumed.fit(batches)
    a, b = straight.task, resumed.task
    assert (a.step, a.updates) == (b.step, b.updates) == (4, 4)
    for (ka, pa), (kb, pb) in zip(a.model.state_dict().items(),
                                  b.model.state_dict().items()):
        assert ka == kb and torch.equal(pa, pb), ka
    sa, sb = a.optimizer.state_dict(), b.optimizer.state_dict()
    assert sa['param_groups'] == sb['param_groups']
    for i, st in sa['state'].items():
        for k, v in st.items():
            assert torch.equal(v, sb['state'][i][k]), (i, k)


def test_early_stopping_and_best_match_jax(params, caps, tmp_path):
    """On a scripted validation metric both Trainers stop at the same
    epoch and keep the same epoch as 'best'."""
    script = [10., 12., 11., 12., 13., 13., 9.]
    runs = {}
    for side in ('port', 'jax'):
        it = iter(script)
        d = str(tmp_path / side)
        kw = dict(output_dir=d, max_epochs=len(script),
                  check_val_every_n_epoch=1, early_stopping_patience=2)
        if side == 'port':
            t = ttrainer.Trainer(_port_task(params), caps[0], **kw)
            t.validate = lambda loader, **_: {'miou': next(it)}
            t.fit([], [])
        else:
            task = JTask(net=JSPT(**NARROW), num_classes=13, **HPARAMS)
            t = jtrainer.Trainer(task, caps[2], **kw)
            t.validate = lambda state, loader, **_: {'miou': next(it)}
            t.fit(_jax_state(task, params), [], [])
        best = json.load(open(osp.join(d, 'checkpoints', 'best',
                                       'spt_meta.json')))
        runs[side] = (t.epoch, t.best_miou, best['epoch'],
                      len(_csv(osp.join(d, 'metrics.csv'))[1]))
    assert runs['port'] == runs['jax'] == (3, 12., 2, 4)


def test_plateau_controller_matches_jax():
    metrics = [1., 2., 2., 2., 1.5, 3., 3., 3., 3., 2.9, 4.]
    for kw in (dict(patience=1), dict(patience=0, cooldown=1),
               dict(mode='min', patience=1, threshold_mode='abs',
                    threshold=0.2, factor=0.3)):
        got = tsched.ReduceOnPlateau(**kw)
        ref = jsched.ReduceOnPlateau(**kw)
        for m in metrics:
            assert got.step(m) == ref.step(m)
            assert got.multiplier == ref.multiplier
    np.testing.assert_allclose(
        [tsched.warmup_constant(0.1, 20)(s) for s in (0, 5, 19, 20, 99)],
        [float(jsched.warmup_constant(0.1, 20)(s))
         for s in (0, 5, 19, 20, 99)], rtol=1e-6)


@pytest.fixture(scope='module')
def nag_batches():
    """Two evaluation batches at one padded shape (the JAX step compiles
    once), as (JAX numpy batch, port batch) pairs: of random NAGs, and
    (`True`) of two small synthetic rooms with instance ids, whose
    level-1 instance graph has valid edges."""
    rooms = []
    for seed in (0, 1):
        raw = jsyn.synthetic_room_cloud(seed=seed, n_points=8000)
        raw['obj'] = _instances(raw)
        rooms.append(jpre.preprocess_cloud(raw, with_instances=True, **PRE))
    out = {}
    for instance in (False, True):
        lists = [[rooms[i]] for i in range(2)] if instance else \
            [[random_nag(seed=s) for s in (2 * i, 2 * i + 1)]
             for i in range(2)]
        cfg = jprep.discover_caps(lists, jprep.BatchConfig(
            sample_graph_r=-1, sample_segment_ratio=0, instance=instance),
            train=False, headroom_levels=0)
        out[instance] = []
        for nags in lists:
            b = jprep.prepare_batch(nags, cfg, train=False, device=False)
            if instance:
                assert np.asarray(b[1].obj_edge_mask).sum() > 0
            out[instance].append((b, from_numpy(b, 'cpu', train=True)))
    return out


def _updates(final, start):
    return {k: final[k] - start[k] for k in start}


def _assert_updates_match(port_task, jax_params, start):
    got = _updates({k: p.detach().numpy() for k, p in
                    port_task.model.named_parameters()}, start)
    ref = _updates(_flat(jax_params), start)
    for key in start:
        assert np.abs(ref[key]).max() > 0, key
        err = _rel_l2(got[key], ref[key])
        assert err <= TOL_F32['update'], f'{key}: update L2 err {err:.3e}'


def test_plateau_optimizer_steps_match_jax(params, nag_batches):
    """Three plateau-optimizer steps with one cut (x 0.5 before the
    third): the port scales each group's LR where JAX chains
    optax.scale(lr_mult); the updates agree within TOL_F32['update']."""
    jb, tb = nag_batches[False][0]
    task = JTask(net=JSPT(**NARROW), num_classes=13, scheduler='plateau',
                 **NO_WARMUP)
    state = _jax_state(task, params, tx=jsched.make_plateau_optimizer(
        lr=task.lr, weight_decay=task.weight_decay,
        transformer_lr_scale=task.transformer_lr_scale,
        num_warmup_steps=task.warmup_steps, params=params))
    port = _port_task(params, scheduler='plateau', warmup_steps=0)
    rng = jax.random.PRNGKey(0)
    for step in range(3):
        if step == 2:
            state = state.replace(opt_state=jsched.set_lr_multiplier(
                state.opt_state, 0.5))
            tsched.set_lr_multiplier(port, 0.5)
        state, _ = task.train_step(state, jb, rng)
        port.train_step(tb)
    lrs = [g['lr'] for g in port.optimizer.param_groups]
    np.testing.assert_allclose(lrs, [HPARAMS['lr'] * 0.5, HPARAMS['lr']
                                     * HPARAMS['transformer_lr_scale'] * 0.5],
                               rtol=1e-12)
    # the constant schedule after the warm-up, which the cut scales
    assert [s(2) for s in port.schedules] == [
        HPARAMS['lr'], HPARAMS['lr'] * HPARAMS['transformer_lr_scale']]
    _assert_updates_match(port, state.params, _flat(params))


@pytest.mark.parametrize('panoptic', [False, True],
                         ids=['semantic', 'panoptic'])
def test_accumulation_matches_optax_multisteps(params, nag_batches,
                                               panoptic):
    """accumulate_grad_batches=2 over batches A, B, A, B: no parameter
    moves after A; after B one AdamW update on the mean gradient at the
    LR of update 0, after the second B one at update 1; `step` counts
    micro-steps and the logged `lr_at` reads it, as in JAX."""
    pairs = nag_batches[panoptic]
    jcls, tcls = (JPan, PanopticTask) if panoptic else (JTask, SemanticTask)
    task = jcls(net=JSPT(**NARROW), num_classes=13,
                accumulate_grad_batches=2, **NO_WARMUP)
    # the panoptic model has the edge-affinity head's parameters too
    pparams = _params(task.model, pairs[0][0]) if panoptic else params
    tx = optax.MultiSteps(jsched.make_optimizer(
        lr=task.lr, weight_decay=task.weight_decay,
        transformer_lr_scale=task.transformer_lr_scale,
        total_steps=task.total_steps, num_warmup_steps=task.warmup_steps,
        params=pparams), every_k_schedule=2)
    state = _jax_state(task, pparams, tx=tx)
    port = _port_task(pparams, cls=tcls, accumulate_grad_batches=2,
                      warmup_steps=0)
    start = _flat(pparams)
    rng = jax.random.PRNGKey(0)
    for micro in range(4):
        jb, tb = pairs[micro % 2]
        state, jm = task.train_step(state, jb, rng)
        m = port.train_step(tb)
        np.testing.assert_allclose(m['loss'].item(), float(jm['loss']),
                                   rtol=TOL_F32['loss'])
        if micro == 0:
            for k, p in port.model.named_parameters():
                assert np.array_equal(p.detach().numpy(), start[k]), k
            for k, v in _flat(state.params).items():
                assert np.array_equal(v, start[k]), k
        if micro == 1:
            _assert_updates_match(port, state.params, start)
    assert (port.step, port.updates, port.mini_step) == (4, 2, 0)
    assert int(state.step) == 4
    # the second update ran at the schedule's LR of update 1
    np.testing.assert_allclose(
        [g['lr'] for g in port.optimizer.param_groups],
        [s(1) for s in port.schedules], rtol=0)
    np.testing.assert_allclose(port.lr_at(port.step),
                               task.lr_at(int(state.step)), rtol=1e-12)
    _assert_updates_match(port, state.params, start)


def _spy(obj, log, jax_side):
    """Record the level-1 logits of every eval_step of `obj`."""
    orig = obj.eval_step

    def eval_step(*args):
        out = orig(*args)
        log.append(np.asarray(out['logits_level1']) if jax_side
                   else out['logits_level1'].numpy())
        return out
    obj.eval_step = eval_step


def test_tta_validation_matches_jax(rooms, caps, params, tmp_path):
    """validate(tta_runs=2): the clean pass plus 2 augmented ones summed
    before the argmax; the confusion matrix equals JAX's over the
    clear-margin nodes, and each side's matrix is its own sums'."""
    tt = ttrainer.Trainer(_port_task(params), caps[0], caps[1],
                          output_dir=str(tmp_path / 'port'))
    task = JTask(net=JSPT(**NARROW), num_classes=13, **HPARAMS)
    jt = jtrainer.Trainer(task, caps[2], caps[3],
                          output_dir=str(tmp_path / 'jax'))
    logs = {'port': [], 'jax': []}
    _spy(tt.task, logs['port'], False)
    _spy(task, logs['jax'], True)
    got = tt.validate(tds.DataLoader([rooms['val'][0][0]], batch_size=1),
                      tta_runs=2)
    ref = jt.validate(_jax_state(task, params),
                      jds.DataLoader([rooms['val'][1][0]], batch_size=1),
                      tta_runs=2)
    assert len(logs['port']) == len(logs['jax']) == 3
    batch = jprep.prepare_batch([rooms['val'][1][0]], caps[3], train=False,
                                device=False)
    y, mask = np.asarray(batch[1].y), np.asarray(batch[1].node_mask)
    accs = {s: np.sum([np.asarray(x, np.float64) for x in logs[s]], 0)
            .astype(np.float32) for s in logs}
    for side, m in (('port', got), ('jax', ref)):
        cm = ttrainer.ConfusionMatrix(13)
        cm.update(accs[side], y, node_mask=mask)
        np.testing.assert_array_equal(m['confmat'], cm.confmat)
    top2 = np.sort(accs['jax'], axis=1)[:, -2:]
    sure = (top2[:, 1] - top2[:, 0] > MARGIN) & mask
    assert sure[mask].mean() > 0.9
    cms = []
    for side in ('port', 'jax'):
        cm = ttrainer.ConfusionMatrix(13)
        cm.update(accs[side][sure], y[sure])
        cms.append(cm.confmat)
    np.testing.assert_array_equal(*cms)
