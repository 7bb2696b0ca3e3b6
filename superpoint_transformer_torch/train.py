"""Training entry point of the port:

    python -m superpoint_transformer_torch.train experiment=semantic/s3dis \
        [key=value ...] [device=cpu]

`main(argv)` composes `configs/` (the grammar of the JAX `train.py`);
`train(cfg, datasets=None)` does the work: it processes the missing
clouds, pins the batch capacities (`discover_caps`: training from a few
probe batches, evaluation from the whole validation split), takes the
class weights, builds the task and fits, resuming from `ckpt_path`. The
run is on the card unless `device=cpu`; without a card it raises.

EZ-SP trains in two stages:

    python -m superpoint_transformer_torch.train \
        experiment=partition/s3dis_ezsp
    python -m superpoint_transformer_torch.train \
        experiment=semantic/s3dis_ezsp \
        datamodule.pretrained_cnn_ckpt_path=<stage 1>/checkpoints/last

The first fits the partition task (`trainer.fit_partition`: the sparse
CNN under the contrastive edge loss, checkpoints `last` and `best`); the
second preprocesses with the frozen CNN and the greedy contour-prior
partition, then fits SPT as above.
"""
import os.path as osp
import sys

import numpy as np
import torch

CONFIG_DIR = osp.join(osp.dirname(osp.dirname(osp.abspath(__file__))),
                      'configs')

__all__ = ['main', 'train', 'CONFIG_DIR']


def _device(cfg, fn):
    """The run's device: `cfg.device`, else the card, which must exist
    (no fallback to the CPU)."""
    device = torch.device(cfg.get('device') or 'cuda')
    if device.type == 'cuda' and not torch.cuda.is_available():
        raise RuntimeError(f'{fn}: no CUDA device; give the override '
                           'device=cpu to run on the CPU')
    return device


def train(cfg, datasets=None):
    """Fit the task of `cfg` (a `Config` or a nested dict shaped like
    `experiment.FLAGSHIP_CFG`). `datasets` ({'train', 'val'}) replaces
    `build_datasets(cfg)`. Returns the `Trainer`, whose `best_miou` is
    what the JAX `train.py` returns; for the partition task (EZ-SP's
    stage 1: `fit_partition`, no validation, no resume) None, as the JAX
    `train.py` returns."""
    from .datasets import DataLoader, PreparedDataLoader
    from .experiment import (build_batch_config, build_datasets,
                             build_task, precision_to_dtype)
    from .trainer import Trainer
    from .transforms.prepare import discover_caps

    device = _device(cfg, 'train')
    dm, m, tr = cfg['datamodule'], cfg['model'], cfg['trainer']
    seed = int(cfg.get('seed', 0))
    if datasets is None:
        datasets = build_datasets(cfg, stages=('train', 'val'))
    for ds in datasets.values():
        ds.process()

    batch_cfg = build_batch_config(cfg)
    batch_size = int(dm['dataloader']['batch_size'])
    train_loader = DataLoader(datasets['train'], batch_size=batch_size,
                              shuffle=True, seed=seed)
    val_loader = DataLoader(datasets['val'], batch_size=1)

    max_epochs = int(tr['max_epochs'])
    if str(m.get('task', 'semantic')) == 'partition':
        from .trainer import fit_partition
        task = build_task(cfg, num_graphs=max(batch_size, 1),
                          total_steps=max_epochs * max(len(train_loader), 1),
                          device=device)
        fit_partition(task, train_loader, batch_cfg,
                      output_dir=str(cfg.get('output_dir', 'outputs')),
                      max_epochs=max_epochs, seed=seed)
        return None
    devices = int(tr.get('devices', 1))
    # as in JAX: with data parallelism a step takes `devices` batches
    steps_per_epoch = max(len(train_loader) // max(devices, 1), 1)
    class_weight = None
    if m.get('weighted_loss'):
        class_weight = datasets['train'].get_class_weight(
            smooth=str(m.get('weighted_loss_smooth', 'sqrt')))
    task = build_task(cfg, num_graphs=max(batch_size, 1),
                      total_steps=max_epochs * steps_per_epoch,
                      class_weight=class_weight, device=device)

    # one padded shape for every training step, from a few probe
    # batches; evaluation takes whole tiles, so its capacities come from
    # every validation tile
    probe = DataLoader(datasets['train'], batch_size=batch_size,
                       shuffle=True, seed=seed)
    probe_batches = [nags for _, nags in zip(range(4), probe)]
    val_probe = list(DataLoader(datasets['val'], batch_size=1))
    eval_batch_cfg = discover_caps(
        val_probe, batch_cfg, train=False, headroom_levels=0) \
        if val_probe else batch_cfg
    batch_cfg = discover_caps(probe_batches, batch_cfg,
                              rng=np.random.default_rng(seed))
    n_params = sum(p.numel() for p in task.model.parameters())
    dtype = precision_to_dtype(tr.get('precision')) or 'float32'
    print(f'model parameters: {n_params:,} (compute dtype {dtype}, '
          f'device {device})')

    panoptic = {}
    if str(m.get('task', 'semantic')) == 'panoptic':
        panoptic = dict(
            partition_every_n_epoch=int(m.get('partition_every_n_epoch',
                                              50)),
            stuff_classes=tuple(dm.get('stuff_classes', ())),
            panoptic_grid_search=bool(cfg.get('panoptic_grid_search',
                                              True)),
            monitor='pq')
    trainer = Trainer(
        task=task, batch_cfg=batch_cfg, eval_batch_cfg=eval_batch_cfg,
        output_dir=str(cfg.get('output_dir', 'outputs')),
        max_epochs=max_epochs, devices=devices,
        check_val_every_n_epoch=int(tr['check_val_every_n_epoch']),
        early_stopping_patience=int(tr.get('early_stopping_patience', -1)),
        loggers=tuple(tr.get('logger', ('csv',))),
        track_val_idx=int(tr.get('track_val_idx', -1)),
        seed=seed, **panoptic)
    # host batch preparation in worker processes
    loader_workers = int(dm['dataloader'].get('num_workers', 0))
    if loader_workers > 0:
        train_loader = PreparedDataLoader(
            datasets['train'], batch_cfg, batch_size=batch_size,
            shuffle=True, seed=seed, train=True, num_workers=loader_workers,
            device=device, compute_dtype=task.model.net.compute_dtype)
    if cfg.get('ckpt_path'):
        trainer.load_checkpoint(str(cfg['ckpt_path']))
    try:
        trainer.fit(train_loader, val_loader)
    finally:
        if loader_workers > 0:
            train_loader.close()
    return trainer


def main(argv=None):
    from .config import load_config
    argv = sys.argv[1:] if argv is None else list(argv)
    trainer = train(load_config(CONFIG_DIR, 'train', argv))
    return None if trainer is None else trainer.best_miou


if __name__ == '__main__':
    main()
