"""The port's config composition vs the JAX package's: `load_config`
gives the same plain dict for every experiment file, for `eval.yaml`
and with CLI overrides; `FLAGSHIP_CFG`, `PANOPTIC_CFG`, EZ-SP's two
configs (`EZSP_PARTITION_CFG`, `EZSP_CFG`) and nano's two (`NANO_CFG`,
`PANOPTIC_NANO_CFG`) equal the
composed YAML on every key they hold. Exact equality (no tolerance: the
values are parsed, not computed)."""
import glob
import os

import pytest

from superpoint_transformer_tpu.config.loader import load_config as jload
from superpoint_transformer_torch.config import Config, load_config
from superpoint_transformer_torch.experiment import (DALES_CFG, EZSP_CFG,
                                                     EZSP_PARTITION_CFG,
                                                     FLAGSHIP_CFG,
                                                     KITTI360_CFG,
                                                     NANO_CFG,
                                                     PANOPTIC_CFG,
                                                     PANOPTIC_DALES_CFG,
                                                     PANOPTIC_NANO_CFG,
                                                     PANOPTIC_SCANNET_CFG,
                                                     build_task)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CONFIGS = os.path.join(REPO, 'configs')
EXPERIMENTS = sorted(
    os.path.relpath(p, os.path.join(CONFIGS, 'experiment'))[:-len('.yaml')]
    for p in glob.glob(os.path.join(CONFIGS, 'experiment', '**', '*.yaml'),
                       recursive=True))


def _plain(tree):
    """Nested plain dicts and lists, so that the Config classes of the
    two packages compare by content and type."""
    if isinstance(tree, dict):
        return {k: _plain(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_plain(v) for v in tree]
    return tree


def _leaves(tree, prefix=''):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _leaves(v, f'{prefix}.{k}' if prefix else k)
    else:
        yield prefix, tree


def test_every_experiment_file_is_covered():
    assert len(EXPERIMENTS) == 32


@pytest.mark.parametrize('experiment', EXPERIMENTS)
def test_experiment_composes_as_in_jax(experiment):
    argv = [f'experiment={experiment}']
    got = load_config(CONFIGS, 'train', argv)
    assert isinstance(got, Config)
    assert _plain(got) == _plain(jload(CONFIGS, 'train', argv))


@pytest.mark.parametrize('argv', [
    [], ['experiment=semantic/s3dis'],
    ['experiment=panoptic/s3dis', 'ckpt_path=/tmp/x', 'tta_runs=2']],
    ids=['bare', 'semantic', 'panoptic'])
def test_eval_yaml_composes_as_in_jax(argv):
    assert _plain(load_config(CONFIGS, 'eval', argv)) == \
        _plain(jload(CONFIGS, 'eval', argv))


def test_overrides_and_references_as_in_jax():
    argv = ['experiment=semantic/s3dis', 'trainer.max_epochs=3',
            'datamodule.fold=2', 'datamodule.data_dir=/data/s3dis',
            'output_dir=${datamodule.data_dir}/out', 'device=cpu',
            'model.optimizer.weight_decay=1e-2']
    got = load_config(CONFIGS, 'train', argv)
    assert _plain(got) == _plain(jload(CONFIGS, 'train', argv))
    assert got.trainer.max_epochs == 3 and got.datamodule.fold == 2
    assert got.output_dir == '/data/s3dis/out'
    assert got.get_path('datamodule.dataloader.batch_size') == 1
    # YAML 1.1 reads 1e-2 (no dot) as a string, as JAX does
    assert got.model.optimizer.weight_decay == '1e-2'
    assert got.device == 'cpu'


@pytest.mark.parametrize('name,cfg,experiment', [
    ('flagship', FLAGSHIP_CFG, 'semantic/s3dis'),
    ('panoptic', PANOPTIC_CFG, 'panoptic/s3dis'),
    ('ezsp_partition', EZSP_PARTITION_CFG, 'partition/s3dis_ezsp'),
    ('ezsp', EZSP_CFG, 'semantic/s3dis_ezsp'),
    ('nano', NANO_CFG, 'semantic/s3dis_nano'),
    ('panoptic_nano', PANOPTIC_NANO_CFG, 'panoptic/s3dis_nano'),
    ('dales', DALES_CFG, 'semantic/dales'),
    ('kitti360', KITTI360_CFG, 'semantic/kitti360'),
    ('panoptic_scannet', PANOPTIC_SCANNET_CFG, 'panoptic/scannet'),
    ('panoptic_dales', PANOPTIC_DALES_CFG, 'panoptic/dales')],
    ids=['flagship', 'panoptic', 'ezsp_partition', 'ezsp', 'nano',
         'panoptic_nano', 'dales', 'kitti360', 'panoptic_scannet',
         'panoptic_dales'])
def test_builtin_cfg_equals_the_composed_yaml(name, cfg, experiment):
    """Every key that the build functions, the datasets and the Trainer
    read from FLAGSHIP_CFG / PANOPTIC_CFG / EZSP_PARTITION_CFG / EZSP_CFG
    / NANO_CFG / PANOPTIC_NANO_CFG / DALES_CFG / KITTI360_CFG /
    PANOPTIC_SCANNET_CFG / PANOPTIC_DALES_CFG is the port's loader's
    value."""
    composed = load_config(CONFIGS, 'train', [f'experiment={experiment}'])
    leaves = dict(_leaves(cfg))
    # the datamodule, the trainer and the run keys are held too
    assert {'seed', 'output_dir', 'datamodule.voxel',
            'datamodule.dataloader.batch_size', 'trainer.max_epochs',
            'trainer.accumulate_grad_batches'} <= set(leaves)
    for path, value in leaves.items():
        assert composed.get_path(path) == value, path


@pytest.mark.parametrize('experiment', [
    'semantic/s3dis_11g', 'panoptic/s3dis', 'semantic/s3dis_room'])
def test_build_task_reads_accumulation_and_the_scheduler(experiment):
    """The *_11g experiments accumulate 2 batches; the port's build_task
    takes them and every other S3DIS experiment without raising."""
    cfg = load_config(CONFIGS, 'train', [f'experiment={experiment}'])
    task = build_task(cfg, num_graphs=1, device='cpu')
    assert task.accumulate_grad_batches == int(
        cfg.trainer.get('accumulate_grad_batches', 1))
    assert task.scheduler == ('plateau' if 'plateau' in str(
        cfg.model.scheduler.get('_target_', '')).lower() else 'cosine')
    if experiment.endswith('_11g'):
        assert task.accumulate_grad_batches == 2


def _raw_layouts(root):
    """Empty raw files in every dataset's layout, enough for the cloud
    ids: S3DIS rooms, KITTI-360 windows, ScanNet scans and split files
    (DALES lists its tiles)."""
    raw = os.path.join(root, 'raw')
    for area in ('Area_1', 'Area_5'):
        os.makedirs(os.path.join(raw, area, 'office_1', 'Annotations'))
    for split, seq in (('train', '2013_05_28_drive_0000_sync'),
                       ('val', '2013_05_28_drive_0002_sync')):
        d = os.path.join(raw, 'data_3d_semantics', split, seq, 'static')
        os.makedirs(d)
        open(os.path.join(d, '0000000002_0000000385.ply'), 'w').close()
    for split, scans in (('train', ['scene0000_00', 'scene0001_00']),
                         ('val', ['scene0002_00'])):
        for s in scans:
            os.makedirs(os.path.join(raw, 'scans', s))
        with open(os.path.join(raw, f'scannetv2_{split}.txt'), 'w') as f:
            f.write('\n'.join(scans) + '\n')


@pytest.fixture(scope='module')
def layouts(tmp_path_factory):
    root = str(tmp_path_factory.mktemp('layouts'))
    _raw_layouts(root)
    return root


@pytest.mark.parametrize('experiment', EXPERIMENTS)
def test_build_datasets_builds_the_jax_class_and_arguments(layouts,
                                                           experiment):
    """For every experiment file, `build_datasets` builds the port's
    counterpart of the class that the JAX `build_datasets` builds, with
    the same arguments (every attribute but the port's `device`; `fold`
    for the S3DIS datasets only), and the same cloud ids and processed
    paths on a raw tree of every layout."""
    from superpoint_transformer_tpu.experiment import (
        build_datasets as jbuild)
    from superpoint_transformer_torch.experiment import build_datasets
    argv = [f'experiment={experiment}', f'datamodule.data_dir={layouts}']
    got = build_datasets(load_config(CONFIGS, 'train', argv + ['device=cpu']))
    ref = jbuild(jload(CONFIGS, 'train', argv))
    assert sorted(got) == sorted(ref) == ['test', 'train', 'val']
    for stage, r in ref.items():
        g = got[stage]
        assert type(g).__name__ == type(r).__name__
        assert type(g).__module__.split('.')[-1] == \
            type(r).__module__.split('.')[-1]
        attrs = {k: v for k, v in vars(g).items() if k != 'device'}
        assert attrs == vars(r)
        assert g.device == 'cpu'
        assert hasattr(g, 'fold') == type(r).__name__.startswith(
            ('S3DIS', 'MiniS3DIS'))
        assert g.cloud_ids == r.cloud_ids
        assert g.processed_paths == r.processed_paths
