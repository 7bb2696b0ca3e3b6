"""The port's multi-process training and serving (`parallel/`,
`Trainer(devices=2)`) against its single-process runs and the JAX package.

The port's ranks are spawned processes joined by gloo over a file store
(`parallel.multihost.run_ranks`), two ranks on the CPU, which run the
rank functions of `torch_ranks.py` (no jax there). JAX runs in this
process on the suite's virtual CPU devices, its attention on the XLA
path, the port's on K1's and K2's plain versions.

Tolerances: a sharded run differs from the unsharded one only in the
order of the sums over ranks (norm statistics, loss terms, gradients):
its loss within 1e-5 relative, its confusion matrix equal, its outputs
within 5e-5 of the largest. The outputs amplify rounding: GraphNorm's
variance is E[x^2] - mean^2, which cancels, so the two ranks' partial
statistics, a few ulps from the one sum, move the narrow SPT's outputs
by more than the loss (the sharded forward reads 2.2e-5 here). Against JAX: the f32 forward tolerance of
test_torch_spt.py (rtol = atol = 1e-4), losses 1e-4 relative, confusion
matrices equal. Parameters after an AdamW step: each tensor's update
within 1e-2 relative L2 (test_torch_train.py's f32 step tolerance), over
the entries whose gradient exceeds 1e-3. Adam's first step is
lr * g / (|g| + eps), so an entry whose gradient is rounding noise (the
narrow SPT has such tensors: `down_stage_0`'s v_rpe and out_proj biases
shift every node of a graph alike, which the next GraphNorm removes) takes
a step of arbitrary sign; the JAX package's own data-parallel test masks
them the same way (tests/test_train.py)."""
import csv
import dataclasses
import os.path as osp

import numpy as np
import pytest
import torch

import jax

from superpoint_transformer_tpu.models.semantic import (
    SemanticTask as JTask, TrainState)
from superpoint_transformer_tpu.models.spt import SPT as JSPT
from superpoint_transformer_tpu.optim.lr_scheduler import make_optimizer
from superpoint_transformer_tpu.parallel import (
    make_data_mesh as jdata_mesh, make_dp_train_step as jdp_step,
    make_shard_mesh as jshard_mesh, make_sharded_forward as jsharded_fwd,
    make_sharded_train_step as jsharded_step, shard_batch,
    shard_padded_nag as jshard, stack_batches)
from superpoint_transformer_tpu.trainer import Trainer as JTrainer
from superpoint_transformer_tpu.transforms import (
    BatchConfig as JBatchConfig, prepare_batch as jprepare)
from superpoint_transformer_tpu.transforms import runtime as JT
from superpoint_transformer_tpu.utils.synthetic import random_nag as jnag
from superpoint_transformer_torch import train as ttrain
from superpoint_transformer_torch.data.padded import (PaddedLevel,
                                                      PaddedNAG, from_numpy)
from superpoint_transformer_torch.parallel import (launch_multihost_dryrun,
                                                   run_ranks,
                                                   shard_padded_nag)
from superpoint_transformer_torch.parallel.multihost import (dryrun_batch,
                                                             dryrun_task)
from superpoint_transformer_torch.parallel.shard_nag import shard_assignment
from superpoint_transformer_torch.trainer import Trainer
from superpoint_transformer_torch.transforms import runtime as TT
from superpoint_transformer_torch.transforms.prepare import (BatchConfig,
                                                             prepare_batch)
from superpoint_transformer_torch.utils.jax_params import (jax_key_for,
                                                           load_jax_params)
from superpoint_transformer_torch.utils.synthetic import random_nag
from test_cli import _overrides
from test_datasets import make_raw_s3dis
from test_torch_trainer import one_torch_thread  # noqa: F401
import torch_ranks as R

N_DEV = 2
TOL_SHARD_LOSS, TOL_SHARD = 1e-5, 5e-5
TOL_F32 = dict(rtol=1e-4, atol=1e-4)
TOL_UPDATE, GRAD_FLOOR = 1e-2, 1e-3
# spawned ranks that hang fail their test instead of the run
TIMEOUT = 240


def _sharding_input(T, nag):
    """The JAX sharded-attention test's input: the eval transforms of
    `prepare_batch`, applied by hand, one graph."""
    nag = T.node_size(nag, low=0)
    nag = T.on_the_fly_horizontal_edge_features(nag)
    nag = T.add_self_loops(nag)
    nag.add_keys_to(0, list(BatchConfig().point_hf), to='x',
                    delete_after=False)
    for i in nag.levels:
        nag[i]['batch'] = np.zeros(nag[i].num_nodes, dtype=np.int64)
    return nag


def _jax_params(model, batch):
    """Random flax params of `model` drawn with numpy (test_torch_train's
    recipe)."""
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
    """{state_dict key: array} of a flax tree, kernels transposed."""
    out = {}
    for path, leaf in jax.tree_util.tree_leaves_with_path(tree):
        names = tuple(p.key for p in path)
        a = np.asarray(leaf, np.float32)
        out[jax_key_for(names)] = a.T if names[-1] == 'kernel' else a
    return out


def _port_host(b):
    """A JAX host batch (numpy leaves) as the port's `PaddedNAG`."""
    return PaddedNAG(levels=tuple(PaddedLevel(**{
        f.name: getattr(lvl, f.name, None)
        for f in dataclasses.fields(PaddedLevel)}) for lvl in b.levels),
        start_i_level=int(b.start_i_level), num_graphs=int(b.num_graphs))


def _stitch(out, assign):
    """Rank-ordered rows [n_dev * cap, C] back to the NAG's order."""
    rank, local = assign
    cap = out.shape[0] // N_DEV
    return np.asarray(out)[rank.astype(np.int64) * cap + local]


def _check_updates(got, ref, p0, grads):
    """Each tensor's update within TOL_UPDATE (relative L2) where the
    gradient exceeds GRAD_FLOOR."""
    checked = 0
    for k, g in grads.items():
        m = np.abs(g) > GRAD_FLOOR
        if not m.any():
            continue
        checked += int(m.sum())
        du, dr = (got[k] - p0[k])[m], (ref[k] - p0[k])[m]
        err = np.linalg.norm(du - dr) / max(np.linalg.norm(dr), 1e-12)
        assert err < TOL_UPDATE, (k, err)
    assert checked > 1000


@pytest.fixture(scope='module')
def weights():
    """The narrow SPT's task params (flax tree) and the same as a port
    state_dict, from a 1-graph JAX batch."""
    b = jprepare([jnag(seed=0)], JBatchConfig(sample_graph_r=-1,
                                              sample_segment_ratio=0),
                 train=False, device=False)
    task = JTask(net=JSPT(output_stage_wise=True, **R.NARROW),
                 num_classes=13, **R.HPARAMS)
    params = _jax_params(task.model, b)
    port = R.SemanticTask(R.SPT(**R.NARROW), num_classes=13, **R.HPARAMS)
    load_jax_params(port.model, params)
    return params, {k: v.detach().numpy().copy()
                    for k, v in port.model.state_dict().items()}


@pytest.fixture(scope='module')
def graph():
    """One NAG (random_nag, 1200 points) in both packages, its shards and
    the port's unsharded batch of it."""
    kw = dict(seed=0, n_points=1200, n_l1=96, n_l2=24)
    cfg = BatchConfig(sample_graph_r=-1, sample_segment_ratio=0)
    tnag = _sharding_input(TT, random_nag(**kw))
    return dict(
        batch=prepare_batch([random_nag(**kw)], cfg, train=False),
        tnag=tnag, jnag=_sharding_input(JT, jnag(**kw)),
        shards=shard_padded_nag(tnag, N_DEV, num_classes=13))


def test_collectives_match_single_process():
    """all_reduce_sum, all_reduce_min/max and all_gather_rows on 2 ranks,
    and the gradients of sum_r <c_r, f(x_0, x_1)> through the sum and the
    row gather, against the single-process expressions and autograd."""
    rng = np.random.default_rng(0)
    xs = rng.standard_normal((N_DEV, 5, 3)).astype(np.float32)
    idx = rng.integers(0, N_DEV * 5, (N_DEV, 4))
    cs = rng.standard_normal((N_DEV, 5, 3)).astype(np.float32)
    out = run_ranks(R.collectives, N_DEV, args=(xs, idx, cs),
                    timeout=TIMEOUT)

    x = torch.tensor(xs, requires_grad=True)
    s = (x * x).sum(0)
    (s * torch.tensor(cs)).sum().backward()
    sum_grad, x.grad = x.grad.numpy().copy(), None
    table = (x * x).reshape(N_DEV * 5, 3)
    sum(((table[torch.from_numpy(idx[r])] * torch.tensor(cs[r][:4]))
         .sum() for r in range(N_DEV))).backward()
    for r, o in enumerate(out):
        np.testing.assert_array_equal(o['min'], xs.min(0))
        np.testing.assert_array_equal(o['max'], xs.max(0))
        np.testing.assert_allclose(o['sum'], s.detach().numpy(), rtol=1e-6)
        np.testing.assert_allclose(o['sum_grad'], sum_grad[r], rtol=1e-5,
                                   atol=1e-6)
        np.testing.assert_array_equal(o['gather'], table.detach().numpy())
        np.testing.assert_allclose(o['gather_grad'], x.grad[r].numpy(),
                                   rtol=1e-5, atol=1e-6)


def test_shard_padded_nag_matches_jax(graph):
    """Every leaf of every rank's shard equals the JAX stacked shards'
    slice of that device, exactly."""
    ref = jshard(graph['jnag'], N_DEV, num_classes=13)
    for r, shard in enumerate(graph['shards']):
        assert shard.start_i_level == ref.start_i_level
        for got, want in zip(shard.levels, ref.levels):
            for f in dataclasses.fields(want):
                w = getattr(want, f.name)
                g = getattr(got, f.name, None)
                if w is None:
                    assert g is None, f.name
                    continue
                np.testing.assert_array_equal(g, np.asarray(w)[r],
                                              err_msg=f.name)


@pytest.fixture(scope='module')
def sharded_run(graph, weights):
    return run_ranks(R.sharded, N_DEV, args=(graph['shards'], weights[1]),
                     timeout=TIMEOUT)


def test_sharded_forward_matches_unsharded(graph, weights, sharded_run):
    """The 2-rank sharded forward (K2's plain version on gathered k/v
    rows, norm statistics summed over ranks), stitched back to the NAG's
    order, against the port's unsharded forward: every level within
    TOL_SHARD of its largest output."""
    task = R.narrow_task(weights[1])
    task.model.eval()
    with torch.no_grad():
        ref = task.model.net(from_numpy(graph['batch'], 'cpu'))
    assign = shard_assignment(graph['tnag'], N_DEV)
    for out in sharded_run:
        for i, (got, want) in enumerate(zip(out['feats'], ref)):
            want = want.numpy()
            got = _stitch(got, assign[i + 1])
            err = np.abs(got - want[:got.shape[0]]).max() \
                / np.abs(want).max()
            assert err < TOL_SHARD, (i + 1, err)


def test_sharded_forward_matches_jax(graph, weights, sharded_run):
    """The port's sharded forward against JAX's `make_sharded_forward` on
    2 virtual devices, the same weights and shards."""
    mesh = jshard_mesh(jax.devices()[:N_DEV])
    net = JSPT(output_stage_wise=True, shard_axis='shard', **R.NARROW)
    outs = jsharded_fwd(net, mesh)({'params': weights[0]['net']},
                                   jshard(graph['jnag'], N_DEV,
                                          num_classes=13))
    assign = shard_assignment(graph['tnag'], N_DEV)
    for i, want in enumerate(outs):
        np.testing.assert_allclose(
            _stitch(sharded_run[0]['feats'][i], assign[i + 1]),
            _stitch(want, assign[i + 1]), **TOL_F32)


def test_sharded_train_step_matches_unsharded(graph, weights, sharded_run):
    """One sharded train step on 2 ranks against the port's unsharded step
    from the same weights: the loss, the confusion matrix and the
    updated parameters (JAX's test_sharded_attention.py:178)."""
    task = R.narrow_task(weights[1])
    tb = from_numpy(graph['batch'], 'cpu', train=True)
    task.model.train()
    loss, _ = task.loss(tb)
    loss.backward()
    grads = {k: p.grad.numpy().copy()
             for k, p in task.model.named_parameters()}
    metrics = task.train_step(tb)
    ref = R.params(task)
    for out in sharded_run:
        np.testing.assert_allclose(out['loss'], float(metrics['loss']),
                                   rtol=TOL_SHARD_LOSS)
        np.testing.assert_array_equal(out['confmat'],
                                      metrics['confmat'].numpy())
        _check_updates(out['params'], ref, weights[1], grads)


def test_sharded_train_step_matches_jax(graph, weights, sharded_run):
    """The port's 2-rank sharded train step against JAX's
    `make_sharded_train_step` on 2 virtual devices, from the same weights
    and shards: the loss (1e-4 relative) and the confusion matrix equal,
    the parameter updates aligned (cosine at least 0.98, JAX's own bar
    for its sharded step against its unsharded one,
    tests/test_sharded_attention.py), and the gradients JAX steps on are
    the world size times the port's: JAX sums the ranks' gradients of the
    replicated loss, the port averages them (Adam's first step hides the
    factor)."""
    import optax
    task = JTask(net=JSPT(output_stage_wise=True, shard_axis='shard',
                          **R.NARROW), num_classes=13, **R.HPARAMS)
    mesh = jshard_mesh(jax.devices()[:N_DEV])
    state, metrics = jsharded_step(task, mesh)(
        _jax_state(task, weights[0]),
        jshard(graph['jnag'], N_DEV, num_classes=13),
        jax.random.PRNGKey(5))
    ref, p0 = _flat(state.params), weights[1]
    mus = [s.mu for s in jax.tree_util.tree_leaves(
        state.opt_state, is_leaf=lambda s: isinstance(
            s, optax.ScaleByAdamState)) if isinstance(
        s, optax.ScaleByAdamState)]
    # Adam's first moment after one step: (1 - b1) times the gradient
    jax_norm = np.sqrt(sum(float(np.sum(np.square(np.asarray(m))))
                           for mu in mus
                           for m in jax.tree_util.tree_leaves(mu))) / 0.1
    for out in sharded_run:
        np.testing.assert_allclose(out['loss'], float(metrics['loss']),
                                   rtol=1e-4)
        np.testing.assert_array_equal(out['confmat'],
                                      np.asarray(metrics['confmat']))
        d_port = np.concatenate([(out['params'][k] - p0[k]).ravel()
                                 for k in sorted(ref)])
        d_jax = np.concatenate([(ref[k] - p0[k]).ravel()
                                for k in sorted(ref)])
        cos = d_port @ d_jax / (np.linalg.norm(d_port)
                                * np.linalg.norm(d_jax))
        assert cos >= 0.98, cos
        port_norm = np.sqrt(sum(float(np.sum(np.square(g)))
                                for g in out['grads'].values()))
        print(f"sharded step vs JAX: update cosine {cos:.6f}, gradient "
              f"ratio {jax_norm / port_norm:.6f}")
        np.testing.assert_allclose(jax_norm / port_norm, N_DEV, rtol=1e-3)


def _jax_batches(n):
    cfg = JBatchConfig(sample_graph_r=-1, sample_segment_ratio=0)
    return [jprepare([jnag(seed=s, n_points=256, n_l1=32, n_l2=8)], cfg,
                     train=False, device=False) for s in range(n)]


def _jax_state(task, params):
    return TrainState.create(
        apply_fn=task.model.apply, params=params,
        tx=make_optimizer(lr=task.lr, weight_decay=task.weight_decay,
                          transformer_lr_scale=task.transformer_lr_scale,
                          total_steps=task.total_steps,
                          num_warmup_steps=task.warmup_steps,
                          params=params))


def _mean_grads(state, batches):
    """The mean of the port's gradients over `batches` (JAX host batches)
    at the weights `state`: where `_check_updates` looks."""
    task = R.narrow_task(state)
    task.model.train()
    for b in batches:
        loss, _ = task.loss(from_numpy(_port_host(b), 'cpu', train=True))
        (loss / len(batches)).backward()
    return {k: p.grad.numpy() for k, p in task.model.named_parameters()}


@pytest.fixture(scope='module')
def dp_run(weights):
    batches = _jax_batches(N_DEV)
    return batches, run_ranks(R.data_parallel, N_DEV, args=(
        [_port_host(b) for b in batches], weights[1]), timeout=TIMEOUT)


def test_dp_step_matches_jax(weights, dp_run):
    """One 2-rank data-parallel step against JAX's `make_dp_train_step`
    on 2 virtual devices (tests/test_train.py:117): the mean loss, the
    summed confusion matrix, the updated parameters."""
    batches, out = dp_run
    task = JTask(net=JSPT(output_stage_wise=True, **R.NARROW),
                 num_classes=13, **R.HPARAMS)
    params = weights[0]
    mesh = jdata_mesh(jax.devices()[:N_DEV])
    state, metrics = jdp_step(task, mesh)(
        _jax_state(task, params), shard_batch(stack_batches(batches), mesh),
        jax.random.PRNGKey(1))
    grads = _mean_grads(weights[1], batches)
    for o in out:
        np.testing.assert_allclose(o['loss'], float(metrics['loss']),
                                   rtol=1e-4)
        np.testing.assert_array_equal(o['confmat'],
                                      np.asarray(metrics['confmat']))
        _check_updates(o['params'], _flat(state.params), weights[1], grads)
    assert all(o['confmat'].sum() > 0 for o in out)


def test_dp_step_refuses_what_jax_refuses(dp_run):
    """The data-parallel step takes the semantic task only (JAX's unpacks
    the semantic loss and fails on the panoptic one), and neither step
    takes a model built for the other."""
    refused = dp_run[1][0]['refused']
    assert set(refused) == {'panoptic', 'sharded_model', 'unsharded_model'}
    assert 'semantic task only' in refused['panoptic']


def test_trainer_devices_matches_jax(tmp_path, weights):
    """`Trainer(devices=2)` on the CPU (2 spawned gloo ranks) against the
    JAX `Trainer(devices=2)` on the same 4 batches and weights
    (tests/test_train.py:214): one global step per 2 batches, the logged
    loss, the parameter update."""
    batches = _jax_batches(4)
    task = JTask(net=JSPT(output_stage_wise=True, **R.NARROW),
                 num_classes=13, **R.HPARAMS)
    jtr = JTrainer(task=task, batch_cfg=None,
                   output_dir=str(tmp_path / 'jax'), max_epochs=1,
                   devices=N_DEV)
    state = jtr.fit(_jax_state(task, weights[0]), batches)
    assert int(state.step) == 2

    port = R.narrow_task(weights[1])
    tr = Trainer(task=port, batch_cfg=None, output_dir=str(tmp_path / 'pt'),
                 max_epochs=1, devices=N_DEV)
    tr.fit([from_numpy(_port_host(b), 'cpu', train=True) for b in batches])
    assert port.step == 2 and port.updates == 2 and tr.epoch == 0
    assert tr.epoch_times[0]['steps'] == 2

    def logged(d):
        with open(osp.join(d, 'metrics.csv')) as f:
            return [float(r['loss']) for r in csv.DictReader(f)
                    if r['split'] == 'train']
    got, want = logged(tmp_path / 'pt'), logged(tmp_path / 'jax')
    assert len(got) == len(want) == 1
    np.testing.assert_allclose(got, want, rtol=1e-4)
    # the update of the two steps, where the first step's gradient is
    # above the floor
    grads = _mean_grads(weights[1], batches[:N_DEV])
    _check_updates(R.params(port), _flat(state.params), weights[1], grads)
    assert osp.exists(tmp_path / 'pt' / 'checkpoints' / 'last' / 'state.pt')


def test_trainer_devices_refusals(weights, monkeypatch):
    """Trainer(devices=2) refuses gradient accumulation and the panoptic
    task as JAX does, and, on CUDA, fewer cards than ranks."""
    task = R.narrow_task(weights[1])
    task.accumulate_grad_batches = 2
    with pytest.raises(ValueError, match='accumulate_grad_batches'):
        Trainer(task=task, batch_cfg=None, devices=2)
    task.accumulate_grad_batches = 1
    monkeypatch.setattr(Trainer, 'device',
                        property(lambda self: torch.device('cuda', 0)))
    monkeypatch.setattr(torch.cuda, 'device_count', lambda: 1)
    with pytest.raises(RuntimeError, match='trainer.devices=2 but only 1'):
        Trainer(task=task, batch_cfg=None, devices=2)


def test_train_cli_data_parallel(tmp_path):
    """`trainer.devices=2` through the port's `train.main` (the JAX
    tests/test_cli.py:443): 5 training areas, one room each, a batch a
    room: two 2-rank steps and a dropped trailing batch; a finite logged
    loss and a finite best mIoU."""
    root = str(tmp_path / 's3dis')
    make_raw_s3dis(root, areas=[f'Area_{i}' for i in range(1, 7)],
                   rooms=1, n_per_obj=150)
    out = str(tmp_path / 'out')
    argv = [o for o in _overrides(root, out)
            if not o.startswith(('datamodule.dataloader.batch_size',
                                 'datamodule.mini'))]
    best = ttrain.main(argv + [
        'datamodule.dataloader.batch_size=1', 'trainer.devices=2',
        'model._point_mlp=[16,32,32]', 'model._down_dim=[32,32]',
        'model._up_dim=[32]', 'model.net.down_num_heads=4',
        'model.net.up_num_heads=4', 'trainer.precision=32', 'device=cpu'])
    assert np.isfinite(best)
    with open(osp.join(out, 'metrics.csv')) as f:
        rows = [r for r in csv.DictReader(f) if r['split'] == 'train']
    assert len(rows) == 1 and np.isfinite(float(rows[0]['loss']))


def test_multihost_dryrun_matches_single_process():
    """2 "hosts" x 2 ranks, one process a rank over TCP, one global
    data-parallel step of the flagship (bf16) against the same 4 batches
    in this process at the same weights: the confusion matrix equal, the
    loss within 1e-4 (tests/test_multihost.py)."""
    results = launch_multihost_dryrun(n_proc=2, n_dev=4, timeout=TIMEOUT)
    assert [(r['host'], r['local_rank']) for r in results] == \
        [(0, 0), (0, 1), (1, 0), (1, 1)]
    task = dryrun_task()
    task.model.train()
    losses, cm = [], 0
    for g in range(4):
        batch = from_numpy(dryrun_batch(g), 'cpu',
                           task.model.net.compute_dtype, train=True)
        with torch.no_grad():
            loss, logits = task.loss(batch)
        losses.append(float(loss))
        cm = cm + task._confmat(logits, batch).numpy()
    np.testing.assert_array_equal(results[0]['confmat'], cm)
    assert abs(results[0]['loss'] - np.mean(losses)) \
        <= 1e-4 * max(1.0, abs(np.mean(losses)))
