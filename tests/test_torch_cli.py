"""The port's `train` and `eval` entry points on the CPU (`device=cpu`)
on a tiny synthetic S3DIS (the recipe of tests/test_cli.py), at narrow
width in f32: a run writes checkpoints and metrics; the port's eval of
its checkpoint gives the JAX eval CLI's confusion matrix on the same
weights (copied into an orbax checkpoint), equal on every node whose
level-1 top-2 logit margin exceeds MARGIN, and off by at most the other
nodes' label mass; the 11g experiment (gradient accumulation) trains and
evaluates with TTA; the 6-fold protocol reads its `{fold}` checkpoints;
the panoptic run validates its partition on its cadence and keeps the
grid-searched settings; DALES, KITTI-360 and ScanNet (tests/test_cli.py's
trees of 2,500 random points a cloud; KITTI-360's and ScanNet's written
with the port's `write_ply`, with a labelled test cloud added) train
SPT-3 at narrow width, evaluate their checkpoint and write their
submission files."""
import glob
import json
import os
import os.path as osp
import shutil

import jax
import numpy as np
import pytest
import torch

import eval as jeval_cli
from superpoint_transformer_tpu import experiment as jexp
from superpoint_transformer_tpu import trainer as jtrainer
from superpoint_transformer_tpu.config.loader import load_config as jload
from superpoint_transformer_tpu.datasets import DataLoader as JLoader
from superpoint_transformer_tpu.models.semantic import SemanticTask as JTask
from superpoint_transformer_tpu.transforms import prepare as jprep
from superpoint_transformer_torch import eval as teval
from superpoint_transformer_torch import train as ttrain
from superpoint_transformer_torch import trainer as ttrainer
from superpoint_transformer_torch.datasets import kitti360 as tds_kitti360
from superpoint_transformer_torch.metrics.semantic import ConfusionMatrix
from superpoint_transformer_torch.models.semantic import SemanticTask
from superpoint_transformer_torch.utils.jax_params import jax_key_for
from superpoint_transformer_torch.utils.ply import write_ply
from test_cli import _make_raw_dales, _overrides
from test_datasets import make_raw_s3dis
from test_torch_trainer import one_torch_thread  # noqa: F401

# the clear-margin rule of tests/test_torch_host_path.py: above it, the
# f32 level-1 logits of the two packages have the same argmax
MARGIN = 1e-3
# narrow SPT-2 (H*D = 16, C = 32) in f32
NARROW = ['model._point_mlp=[16,32,32]', 'model._down_dim=[32,32]',
          'model._up_dim=[32]', 'model.net.down_num_heads=4',
          'model.net.up_num_heads=4', 'trainer.precision=32']


@pytest.fixture(scope='module')
def root(tmp_path_factory):
    root = str(tmp_path_factory.mktemp('s3dis'))
    make_raw_s3dis(root)
    return root


def _argv(root, out, experiment='semantic/s3dis'):
    return [o if not o.startswith('experiment=')
            else f'experiment={experiment}'
            for o in _overrides(root, out)] + NARROW + ['device=cpu']


def _jax_checkpoint(port_ckpt, argv, out):
    """The port checkpoint's weights as the JAX Trainer's 'last'
    checkpoint under `out`: the flax tree of the JAX model, filled from
    the port's state_dict (Linear weights transposed back to kernels)."""
    cfg = jload(ttrain.CONFIG_DIR, 'eval', argv)
    task = jexp.build_task(cfg)
    ds = jexp.build_datasets(cfg, stages=('test',))['test']
    ds.process()
    example = jprep.prepare_batch(next(iter(JLoader(ds))),
                                  jexp.build_batch_config(cfg), train=False)
    state = task.init_state(jax.random.PRNGKey(0), example)
    sd = torch.load(osp.join(port_ckpt, 'state.pt'),
                    weights_only=True)['model']

    def fill(path, leaf):
        names = tuple(p.key for p in path)
        v = sd[jax_key_for(names)].numpy()
        v = v.T if names[-1] == 'kernel' else v
        assert v.shape == leaf.shape, names
        return v.astype(leaf.dtype)

    params = jax.tree_util.tree_map_with_path(fill, state.params)
    jtrainer.Trainer(task=task, batch_cfg=None, output_dir=out) \
        .save_checkpoint(state.replace(params=params), 'last')
    return osp.join(out, 'checkpoints', 'last')


def _spy(monkeypatch, cls, log, jax_side):
    """Record (level-1 logits, label histograms, node mask) of every
    eval_step of `cls`."""
    orig = cls.eval_step

    def eval_step(self, *args):
        out = orig(self, *args)
        batch = args[-1]
        if jax_side:
            log.append([np.asarray(x) for x in (
                out['logits_level1'], batch[1].y, batch[1].node_mask)])
        else:
            log.append([x.float().numpy() for x in (
                out['logits_level1'], batch[1].y, batch[1].node_mask)])
        return out
    monkeypatch.setattr(cls, 'eval_step', eval_step)


def _assert_margin_rule(got, ref, logs, tta_runs):
    """The two evaluations' confusion matrices: equal over the nodes
    whose JAX logits (summed over the TTA passes) clear MARGIN, and off
    by at most the label mass of the other nodes."""
    runs = tta_runs + 1
    assert len(logs['port']) == len(logs['jax'])
    num_classes = logs['jax'][0][1].shape[1] - 1
    sure_cm = {s: ConfusionMatrix(num_classes) for s in logs}
    unsure_mass = 0.0
    for b in range(0, len(logs['jax']), runs):
        acc = {s: np.sum([np.asarray(logs[s][b + r][0], np.float64)
                          for r in range(runs)], 0) for s in logs}
        y, mask = logs['jax'][b][1], logs['jax'][b][2].astype(bool)
        np.testing.assert_array_equal(logs['port'][b][1], y)
        top2 = np.sort(acc['jax'], axis=1)[:, -2:]
        sure = (top2[:, 1] - top2[:, 0] > MARGIN) & mask
        unsure_mass += y[mask & ~sure][:, :num_classes].sum()
        for s in logs:
            sure_cm[s].update(acc[s][sure].astype(np.float32), y[sure])
    np.testing.assert_array_equal(sure_cm['port'].confmat,
                                  sure_cm['jax'].confmat)
    diff = np.abs(got['confmat'] - ref['confmat']).sum()
    assert diff <= 2 * unsure_mass
    if unsure_mass == 0:
        assert got['miou'] == ref['miou'] and got['oa'] == ref['oa']


@pytest.mark.parametrize('experiment,tta_runs', [
    ('semantic/s3dis', 0), ('semantic/s3dis_11g', 2)],
    ids=['s3dis', 's3dis_11g'])
def test_train_then_eval_matches_the_jax_eval_cli(root, tmp_path,
                                                  monkeypatch, experiment,
                                                  tta_runs):
    out = str(tmp_path / 'out')
    argv = _argv(root, out, experiment)
    # MiniS3DIS trains on one area at batch size 2: one batch an epoch;
    # 11g tiles it 3 x 3 (5 batches) and takes 2 micro-steps an update,
    # so its checkpoint holds an unfinished accumulation
    k, n = (2, 5) if experiment.endswith('_11g') else (1, 1)
    best = ttrain.main(argv)
    assert np.isfinite(best)
    for name in ('last', 'best'):
        assert osp.exists(osp.join(out, 'checkpoints', name, 'state.pt'))
        assert osp.exists(osp.join(out, 'checkpoints', name,
                                   'spt_meta.json'))
    head = open(osp.join(out, 'metrics.csv')).readline().strip()
    assert head == 'epoch,split,loss,miou,oa,macc,lr,time'
    ckpt = osp.join(out, 'checkpoints', 'last')
    state = torch.load(osp.join(ckpt, 'state.pt'), weights_only=True)
    assert (state['step'], state['updates'], state['mini_step']) == \
        (n, n // k, n % k)
    assert (state['grads'] is not None) == (n % k > 0)

    ev = [f'ckpt_path={ckpt}', f'tta_runs={tta_runs}']
    teval.main(argv + ev + ['submission=True'])
    # one file a test cloud (a tile, in 11g), labels on every point
    subs = sorted(glob.glob(osp.join(out, 'submission', '*.txt')))
    assert [osp.basename(p) for p in subs] == \
        (['Area_5.txt'] if n == 1 else
         [f'Area_5__TILE_{i}-{j}.txt' for i in range(3) for j in range(3)])
    assert sum(np.loadtxt(p, ndmin=1).size for p in subs) == 1200 * 2
    logs = {'port': [], 'jax': []}
    _spy(monkeypatch, SemanticTask, logs['port'], False)
    _spy(monkeypatch, JTask, logs['jax'], True)
    got = teval.main(argv + ev)
    jckpt = _jax_checkpoint(ckpt, argv, str(tmp_path / 'jax'))
    ref = jeval_cli.main([a for a in argv if a != 'device=cpu']
                         + [f'ckpt_path={jckpt}', f'tta_runs={tta_runs}',
                            f'output_dir={tmp_path / "jax"}'])
    assert got['confmat'].sum() == ref['confmat'].sum() > 0
    _assert_margin_rule(got, ref, logs, tta_runs)


def test_eval_s3dis_6fold_reads_each_fold_checkpoint(tmp_path_factory,
                                                     monkeypatch):
    """6-fold: each fold evaluates its held-out area from its own
    `{fold}` checkpoint, and the per-fold matrices are summed."""
    root = str(tmp_path_factory.mktemp('s3dis6'))
    make_raw_s3dis(root, areas=[f'Area_{i}' for i in range(1, 7)],
                   rooms=1, n_per_obj=150)
    out = str(tmp_path_factory.mktemp('out6'))
    argv = _argv(root, osp.join(out, 'fold1'))
    ttrain.main(argv)
    for fold in range(2, 7):
        shutil.copytree(osp.join(out, 'fold1', 'checkpoints'),
                        osp.join(out, f'fold{fold}', 'checkpoints'))
    loaded, masses = [], []
    orig = ttrainer.Trainer.load_checkpoint
    orig_validate = ttrainer.Trainer.validate

    def load(self, name):
        loaded.append(name)
        return orig(self, name)

    def validate(self, *a, **kw):
        m = orig_validate(self, *a, **kw)
        masses.append(m['confmat'].sum())
        return m
    monkeypatch.setattr(ttrainer.Trainer, 'load_checkpoint', load)
    monkeypatch.setattr(ttrainer.Trainer, 'validate', validate)
    res = teval.main(argv + ['s3dis_6fold=True', 'ckpt_path=' + osp.join(
        out, 'fold{fold}', 'checkpoints', 'last')])
    assert loaded == [osp.join(out, f'fold{f}', 'checkpoints', 'last')
                      for f in range(1, 7)]
    assert len(masses) == 6 and all(m > 0 for m in masses)
    assert res['confmat'].sum() == sum(masses)
    assert np.isfinite(res['miou'])


def test_train_panoptic_cli_on_its_partition_cadence(root, tmp_path,
                                                     monkeypatch):
    """experiment=panoptic/s3dis: validation every epoch, the partition
    and PQ every 2nd and at the last; the grid search runs once and its
    settings serve the later validation."""
    out = str(tmp_path / 'out')
    calls = []
    search = ttrainer.grid_search_panoptic_partition

    def counting(*a, **kw):
        calls.append(1)
        return search(*a, **kw)
    monkeypatch.setattr(ttrainer, 'grid_search_panoptic_partition',
                        counting)
    argv = [a for a in _argv(root, out, 'panoptic/s3dis')
            if not a.startswith('trainer.max_epochs')]
    ttrain.main(argv + ['trainer.max_epochs=3',
                        'model.partition_every_n_epoch=2'])
    rows = open(osp.join(out, 'panoptic.csv')).read().splitlines()
    head = rows[0].split(',')
    assert 'pq' in head
    assert [r.split(',')[head.index('epoch')] for r in rows[1:]] == \
        ['1', '2']
    assert len(calls) == 1


def test_entry_points_need_a_card_or_device_cpu(root, tmp_path):
    """Without a card and without device=cpu both entry points raise, as
    build_task does; with device=cpu EZ-SP's two stages train on the
    tiny S3DIS tree whose classes touch (tests/test_cli.py's EZ-SP
    recipe: label-crossing edges exist for the contrastive loss): the
    partition task (stage 1), then SPT on the learned partition of its
    checkpoint (stage 2)."""
    argv = [a for a in _argv(root, str(tmp_path / 'o'))
            if a != 'device=cpu']
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match='no CUDA device'):
            ttrain.main(argv)
        with pytest.raises(RuntimeError, match='no CUDA device'):
            teval.main(argv)
    root = str(tmp_path / 's3dis')
    make_raw_s3dis(root, z_step=0.1)
    out1 = str(tmp_path / 'p')
    assert ttrain.main(_argv(root, out1, 'partition/s3dis_ezsp')) is None
    head = open(osp.join(out1, 'metrics.csv')).readline().strip()
    assert head == 'epoch,split,loss,n_inter_edge,time'
    ckpt = osp.join(out1, 'checkpoints', 'last')
    state = torch.load(osp.join(ckpt, 'state.pt'), weights_only=True)
    assert state['step'] == 1 and state['model'][
        'cnn.block_0.weight'].shape == (32, 27 * 8)
    out2 = str(tmp_path / 's')
    best = ttrain.main(_argv(root, out2, 'semantic/s3dis_ezsp') + [
        f'datamodule.pretrained_cnn_ckpt_path={ckpt}'])
    assert np.isfinite(best)
    assert osp.exists(osp.join(out2, 'checkpoints', 'last', 'state.pt'))
    # the stage-2 clouds went through the greedy partition: a cache of
    # their own beside stage 1's (cut pursuit)
    assert len(glob.glob(osp.join(root, 'processed', 'train', '*'))) >= 2


# narrow SPT-3 (H*D = 8, C = 16) in f32, and tests/test_cli.py's 3-level
# partition of its tiny clouds
NARROW_SPT3 = ['model._point_mlp=[16,16,16]', 'model._down_dim=[16,16,16]',
               'model._up_dim=[16,16]', 'model.net.down_num_heads=2',
               'model.net.up_num_heads=2', 'trainer.precision=32']
PARTITION_3 = ['datamodule.pcp_regularization=[0.05,0.2,0.4]',
               'datamodule.pcp_spatial_weight=[2.0,0.5,0.5]',
               'datamodule.pcp_cutoff=[5,5,5]',
               'datamodule.graph_gap=[0.5,1.0,2.0]']
CLI_POINTS = 2500


def _raw_kitti360(root, rng):
    """tests/test_cli.py's KITTI-360 tree (a window for train and val)
    and a labelled test window for the evaluation."""
    n = CLI_POINTS
    for split, seq in (('train', '2013_05_28_drive_0000_sync'),
                       ('val', '2013_05_28_drive_0002_sync'),
                       ('test', '2013_05_28_drive_0008_sync')):
        d = osp.join(root, 'raw', 'data_3d_semantics', split, seq, 'static')
        os.makedirs(d, exist_ok=True)
        write_ply(osp.join(d, '0000000002_0000000385.ply'), {
            'x': rng.uniform(0, 20, n).astype(np.float32),
            'y': rng.uniform(0, 20, n).astype(np.float32),
            'z': rng.uniform(0, 4, n).astype(np.float32),
            'red': rng.integers(0, 255, n).astype(np.uint8),
            'green': rng.integers(0, 255, n).astype(np.uint8),
            'blue': rng.integers(0, 255, n).astype(np.uint8),
            'semantic': rng.integers(7, 23, n).astype(np.int32)})


def _raw_scannet(root, rng):
    """tests/test_cli.py's ScanNet tree (two scans, one a split) and a
    labelled test scan for the evaluation."""
    n = CLI_POINTS
    scans = ['scene0000_00', 'scene0001_00', 'scene0707_00']
    for scan in scans:
        d = osp.join(root, 'raw', 'scans_test' if scan == scans[-1]
                     else 'scans', scan)
        os.makedirs(d, exist_ok=True)
        base = {'x': rng.uniform(0, 8, n).astype(np.float32),
                'y': rng.uniform(0, 8, n).astype(np.float32),
                'z': rng.uniform(0, 3, n).astype(np.float32),
                'red': rng.integers(0, 255, n).astype(np.uint8),
                'green': rng.integers(0, 255, n).astype(np.uint8),
                'blue': rng.integers(0, 255, n).astype(np.uint8)}
        write_ply(osp.join(d, f'{scan}_vh_clean_2.ply'), base)
        write_ply(osp.join(d, f'{scan}_vh_clean_2.labels.ply'),
                  {**base, 'label': rng.integers(1, 41, n).astype(
                      np.uint16)})
        with open(osp.join(
                d, f'{scan}_vh_clean_2.0.010000.segs.json'), 'w') as f:
            json.dump({'segIndices': (np.arange(n) // 50).tolist()}, f)
        with open(osp.join(d, f'{scan}.aggregation.json'), 'w') as f:
            json.dump({'segGroups': [
                {'objectId': i, 'segments': list(range(i * 10,
                                                       i * 10 + 10))}
                for i in range(5)]}, f)
    for split, members in (('train', scans[:1]), ('val', scans[1:2]),
                           ('test', scans[2:])):
        with open(osp.join(root, 'raw', f'scannetv2_{split}.txt'), 'w') as f:
            f.write('\n'.join(members) + '\n')


# experiment, tree writer, tests/test_cli.py's overrides it keeps
CLI_DATASETS = {
    'dales': ('semantic/dales', lambda root, rng: _make_raw_dales(root),
              PARTITION_3),
    'kitti360': ('semantic/kitti360', _raw_kitti360, PARTITION_3),
    'scannet': ('panoptic/scannet', _raw_scannet, PARTITION_3)}


@pytest.mark.parametrize('dataset', sorted(CLI_DATASETS))
def test_train_dataset_cli(tmp_path, dataset):
    """tests/test_cli.py's `test_train_{dales,kitti360,scannet}_cli` in
    the port (device=cpu): the reader and the dataset's split lists,
    SPT-3 (panoptic on ScanNet) trained for an epoch and its checkpoint
    evaluated on the test clouds (PQ too on ScanNet), with the
    submission files in each benchmark's format."""
    experiment, write, keep = CLI_DATASETS[dataset]
    root = str(tmp_path / dataset)
    os.makedirs(osp.join(root, 'raw'))
    write(root, np.random.default_rng(0))
    out = str(tmp_path / 'out')
    argv = [o for o in _argv(root, out, experiment)
            if not o.startswith(('datamodule.pcp_', 'datamodule.graph_gap',
                                 'datamodule.mini'))
            and o not in NARROW]
    argv += keep + NARROW_SPT3 + (
        ['datamodule.mini=True'] if dataset == 'dales' else [])
    best = ttrain.main(argv)
    assert np.isfinite(best)
    ckpt = osp.join(out, 'checkpoints', 'last')
    assert osp.exists(osp.join(ckpt, 'state.pt'))
    sd = torch.load(osp.join(ckpt, 'state.pt'), weights_only=True)['model']
    # SPT-3: three down stages of 16 channels, two up stages
    assert sd['net.down_stage_2.in_mlp.linear_0.weight'].shape[0] == 16
    assert 'net.up_stage_1.in_mlp.linear_0.weight' in sd
    assert 'net.down_stage_3.in_mlp.linear_0.weight' not in sd
    got = teval.main(argv + [f'ckpt_path={ckpt}', 'submission=True'])
    assert got['confmat'].sum() > 0 and np.isfinite(got['miou'])
    if dataset == 'scannet':
        assert 0 <= got['pq'] <= 100
    # the held-out predictions in the benchmark's format, one label a
    # raw point
    subs = glob.glob(osp.join(out, 'submission', '*'))
    assert len(subs) == (2 if dataset == 'dales' else 1)
    labels = [np.load(p) if p.endswith('.npy') else np.loadtxt(p)
              for p in subs]
    assert all(lab.shape == (CLI_POINTS,) for lab in labels)
    if dataset == 'kitti360':
        assert osp.basename(subs[0]) == \
            '0008_0000000002_0000000385.npy'
        assert labels[0].dtype == np.uint8
        assert set(np.unique(labels[0])) <= set(
            tds_kitti360.KITTI360_TRAINID2ID.tolist())


def test_kitti360_nano_raises_on_mean_hsv_as_jax(tmp_path):
    """experiment=semantic/kitti360_nano puts 'hsv' in segment_mean_hf,
    but no caller of either package computes hsv: preprocessing skips
    the missing key, and the first batch raises on 'mean_hsv' in both
    packages alike (mirrored from the JAX package, not repaired)."""
    root = str(tmp_path / 'kitti360')
    os.makedirs(osp.join(root, 'raw'))
    _raw_kitti360(root, np.random.default_rng(0))
    out = str(tmp_path / 'out')
    argv = [o for o in _argv(root, out, 'semantic/kitti360_nano')
            if not o.startswith(('datamodule.pcp_', 'datamodule.graph_gap',
                                 'datamodule.mini', 'model.'))
            and o != 'device=cpu'] + PARTITION_3
    import train as jtrain_cli
    for main, extra in ((jtrain_cli.main, []),
                        (ttrain.main, ['device=cpu'])):
        with pytest.raises(KeyError, match="'mean_hsv' at level 1"):
            main(argv + extra)
