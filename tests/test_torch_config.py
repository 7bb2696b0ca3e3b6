"""The port's config composition vs the JAX package's: `load_config`
gives the same plain dict for every experiment file, for `eval.yaml`
and with CLI overrides; `FLAGSHIP_CFG`, `PANOPTIC_CFG` and EZ-SP's two
configs (`EZSP_PARTITION_CFG`, `EZSP_CFG`) equal the
composed YAML on every key they hold. Exact equality (no tolerance: the
values are parsed, not computed)."""
import glob
import os

import pytest

from superpoint_transformer_tpu.config.loader import load_config as jload
from superpoint_transformer_torch.config import Config, load_config
from superpoint_transformer_torch.experiment import (EZSP_CFG,
                                                     EZSP_PARTITION_CFG,
                                                     FLAGSHIP_CFG,
                                                     PANOPTIC_CFG,
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
    ('ezsp', EZSP_CFG, 'semantic/s3dis_ezsp')],
    ids=['flagship', 'panoptic', 'ezsp_partition', 'ezsp'])
def test_builtin_cfg_equals_the_composed_yaml(name, cfg, experiment):
    """Every key that the build functions, the datasets and the Trainer
    read from FLAGSHIP_CFG / PANOPTIC_CFG / EZSP_PARTITION_CFG / EZSP_CFG
    is the port's loader's value."""
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
