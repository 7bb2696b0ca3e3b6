"""Training and evaluation loops: the `Trainer` (fit, validation with
test-time augmentation, test, early stopping, best-model selection, the
plateau controller, the panoptic cadence, checkpoints), its loggers and
the panoptic validation epoch `validate_panoptic`, and EZ-SP's stage-1
loop `fit_partition`. Counterparts of those in
`superpoint_transformer_tpu/trainer.py`.

Checkpoints go under `<output_dir>/checkpoints/{last,best}/`: a
`torch.save` of the task's state (the model's and the optimizer's
`state_dict`, the step counts, the plateau multiplier, the gradients of
an unfinished accumulation) as `state.pt`, beside the `spt_meta.json`
that the JAX Trainer writes.

`Trainer(devices=D)` trains data-parallel over D ranks, one process
each (`parallel/`): `fit` spawns them, each with its own copy of the
task and the loaders, and takes rank 0's trained task back.
"""
import csv
import dataclasses
import json
import os
import os.path as osp
import tempfile
import time
from dataclasses import dataclass
from itertools import islice
from typing import Optional

import numpy as np
import torch
import torch.distributed as dist

from . import __version__
from .data.csr import InstanceData
from .data.padded import PaddedNAG, from_numpy
from .metrics.mean_average_precision import MeanAveragePrecision3D
from .metrics.panoptic import PanopticQuality3D
from .metrics.semantic import ConfusionMatrix
from .models.panoptic import (grid_search_panoptic_partition,
                              instance_partition)
from .optim.lr_scheduler import ReduceOnPlateau, set_lr_multiplier
from .transforms.prepare import prepare_batch, prepare_partition_batch

__all__ = ['Trainer', 'CSVLogger', 'TensorBoardLogger', 'WandbLogger',
           'MultiLogger', 'make_loggers', 'validate_panoptic',
           'fit_partition']


class CSVLogger:
    """Rows to a CSV file whose columns are the first row's keys."""

    def __init__(self, path):
        self.path = path
        os.makedirs(osp.dirname(path), exist_ok=True)
        self._keys = None

    def log(self, row):
        if self._keys is None:
            self._keys = list(row.keys())
            if not osp.exists(self.path):
                with open(self.path, 'w', newline='') as f:
                    csv.writer(f).writerow(self._keys)
        with open(self.path, 'a', newline='') as f:
            csv.writer(f).writerow([row.get(k) for k in self._keys])


class TensorBoardLogger:
    """Scalars to TensorBoard event files under `<split>/<metric>`, step
    = epoch. Needs the tensorboard package (raises here without it)."""

    def __init__(self, logdir):
        from torch.utils.tensorboard import SummaryWriter
        self.writer = SummaryWriter(logdir)

    def log(self, row):
        epoch = int(row.get('epoch', 0))
        split = row.get('split', '')
        for k, v in row.items():
            if k in ('epoch', 'split') or v is None:
                continue
            if isinstance(v, (int, float)):
                self.writer.add_scalar(f'{split}/{k}', v, epoch)
        self.writer.flush()


class WandbLogger:
    """Rows to a wandb run (`utils/wandb.py:WandbRun`, local files when
    the package is absent), and the validation confusion-matrix
    figures."""

    def __init__(self, output_dir, project='spt'):
        from .utils.wandb import WandbRun
        self.run = WandbRun(output_dir, project=project)

    def log(self, row):
        split = row.get('split', '')
        flat = {f'{split}/{k}' if split else k: v
                for k, v in row.items() if k != 'split' and v is not None}
        self.run.log(flat, step=row.get('epoch'))

    def log_figure(self, name, fig, step=None):
        self.run.log_figure(name, fig, step=step)


class MultiLogger:
    def __init__(self, loggers):
        self.loggers = list(loggers)

    def log(self, row):
        for lg in self.loggers:
            lg.log(row)

    def log_figure(self, name, fig, step=None):
        for lg in self.loggers:
            if hasattr(lg, 'log_figure'):
                lg.log_figure(name, fig, step=step)

    @property
    def wants_figures(self):
        return any(hasattr(lg, 'log_figure') for lg in self.loggers)


def make_loggers(names, output_dir, csv_name='metrics.csv'):
    """'csv' | 'tensorboard' | 'wandb' names -> a MultiLogger."""
    out = []
    for name in names:
        if name == 'csv':
            out.append(CSVLogger(osp.join(output_dir, csv_name)))
        elif name == 'tensorboard':
            out.append(TensorBoardLogger(osp.join(output_dir, 'tb')))
        elif name == 'wandb':
            out.append(WandbLogger(output_dir))
        else:
            raise ValueError(f"unknown logger {name!r} (expected 'csv', "
                             "'tensorboard' or 'wandb')")
    return MultiLogger(out)


class _StepClock:
    """CUDA events around each train step on a card, read once per epoch
    (no synchronisation in between); None on the CPU."""

    def __init__(self, device):
        self.on = device.type == 'cuda'
        self.pairs = []

    def start(self):
        if self.on:
            e = torch.cuda.Event(enable_timing=True)
            e.record()
            self.pairs.append([e, None])

    def stop(self):
        if self.on:
            e = torch.cuda.Event(enable_timing=True)
            e.record()
            self.pairs[-1][1] = e

    def total_ms(self):
        if not self.on:
            return None
        torch.cuda.synchronize()
        return float(sum(a.elapsed_time(b) for a, b in self.pairs))


@dataclass
class Trainer:
    """Fit and evaluation loops around a `SemanticTask` or `PanopticTask`
    (the port's tasks own their model, optimizer and step counts), on the
    device of the task's model.

    Batches come from a `DataLoader` (lists of NAGs, prepared here with
    `batch_cfg`, augmented for training, `eval_batch_cfg` for evaluation)
    or a `PreparedDataLoader` (ready `PaddedNAG`s). Every epoch's host
    batch preparation, step time (CUDA events on a card), validation and
    wall time land in `epoch_times`.

    `devices` > 1 trains data-parallel, with the JAX Trainer's semantics:
    global step s on rank r takes loader batch `s * devices + r` (a
    trailing incomplete group is dropped), the ranks' gradients and
    losses are averaged and their confusion matrices summed
    (`parallel/mesh.py:make_dp_train_step`), and rank 0 logs, validates
    and checkpoints while the others wait. `fit` spawns the ranks: on
    CUDA, rank r on `cuda:r` over NCCL (the task's model on a card needs
    `devices` cards), on the CPU over gloo. A process that already is one
    of `devices` ranks passes its `mesh` (`make_data_mesh`) and runs its
    share of `fit` itself. Each rank draws its augmentations from its
    own generator (seeded with `seed` on rank 0, `[seed, rank]` on the
    others)."""
    task: object
    batch_cfg: object
    # evaluation takes whole tiles (no crops), so it has its own
    # capacities; defaults to batch_cfg
    eval_batch_cfg: Optional[object] = None
    output_dir: str = 'outputs'
    max_epochs: int = 100
    check_val_every_n_epoch: int = 10
    devices: int = 1
    seed: int = 0
    # panoptic: the instance partition and PQ every N validation epochs
    # (<= 0 disables)
    partition_every_n_epoch: int = -1
    stuff_classes: tuple = ()
    panoptic_grid_search: bool = True
    # the metric that selects the 'best' checkpoint: 'miou' or 'pq'
    monitor: str = 'miou'
    # stop after this many validations without a better monitored metric
    # (<= 0 disables)
    early_stopping_patience: int = -1
    # dump the predictions of this val/test batch index each epoch to
    # <output_dir>/predictions/ (-1 disables, -2: every batch)
    track_val_idx: int = -1
    loggers: tuple = ('csv',)
    # ReduceOnPlateau, where the task's scheduler is 'plateau'
    plateau_factor: float = 0.5
    plateau_patience: int = 3
    # this process's rank (`parallel.mesh.Mesh`) when it runs as one of
    # `devices` ranks
    mesh: Optional[object] = None

    def __post_init__(self):
        if self.devices > 1:
            self._check_devices()
        if self.eval_batch_cfg is None:
            self.eval_batch_cfg = self.batch_cfg
        os.makedirs(self.output_dir, exist_ok=True)
        self.logger = make_loggers(self.loggers if self.is_main else (),
                                   self.output_dir)
        self.best_miou = -1.0
        self.epoch = 0
        self.epoch_times = []
        self._partition_settings = None
        self._stale_validations = 0
        self._plateau = None
        if getattr(self.task, 'scheduler', 'cosine') == 'plateau':
            self._plateau = ReduceOnPlateau(
                mode='max', factor=self.plateau_factor,
                patience=self.plateau_patience)

    @property
    def device(self):
        return next(self.task.model.parameters()).device

    @property
    def is_main(self):
        """Whether this process logs, validates and checkpoints: the only
        one, or rank 0."""
        return self.mesh is None or self.mesh.rank == 0

    def _check_devices(self):
        """The JAX Trainer's refusals for `devices` > 1."""
        if self.device.type == 'cuda' \
                and torch.cuda.device_count() < self.devices:
            raise RuntimeError(
                f'trainer.devices={self.devices} but only '
                f'{torch.cuda.device_count()} CUDA device(s) are visible — '
                'run on a host with more cards or set trainer.devices '
                'accordingly')
        self.task.check_group_step()
        if self.mesh is not None and self.mesh.size != self.devices:
            raise ValueError(f'trainer.devices={self.devices} but the mesh '
                             f'has {self.mesh.size} ranks')

    def _to_device(self, host):
        return from_numpy(host, self.device,
                          self.task.model.net.compute_dtype, train=True,
                          pin_memory=True)

    # -- checkpoints -----------------------------------------------------
    def _ckpt_dir(self, name):
        """`<output_dir>/checkpoints/<name>`, or `name` where it is an
        absolute path."""
        return osp.abspath(osp.join(self.output_dir, 'checkpoints', name))

    def save_checkpoint(self, name='last'):
        path = self._ckpt_dir(name)
        os.makedirs(path, exist_ok=True)
        torch.save(self.task.state_dict(), osp.join(path, 'state.pt'))
        # epoch + 1: the next epoch to run on resume (a checkpoint is
        # written at the end of an epoch)
        meta = {'version': __version__, 'epoch': self.epoch + 1,
                'best_miou': self.best_miou, 'time': time.time()}
        with open(osp.join(path, 'spt_meta.json'), 'w') as f:
            json.dump(meta, f)

    def load_checkpoint(self, name_or_path='last'):
        """Restore the task's state from a checkpoint, and the epoch to
        resume at and the best monitored metric from its metadata."""
        path = self._ckpt_dir(name_or_path)
        # loaded on the host: the optimizer moves its moments to the
        # parameters' device and keeps AdamW's step counts on the host,
        # where its update reads them without a device sync
        self.task.load_state_dict(torch.load(
            osp.join(path, 'state.pt'), map_location='cpu',
            weights_only=True))
        meta_path = osp.join(path, 'spt_meta.json')
        if osp.exists(meta_path):
            with open(meta_path) as f:
                meta = json.load(f)
            self.epoch = int(meta.get('epoch', 0))
            self.best_miou = float(meta.get('best_miou', -1))

    # -- loops -----------------------------------------------------------
    def fit(self, train_loader, val_loader=None):
        """Train from `self.epoch` to `max_epochs`, validating every
        `check_val_every_n_epoch` epochs and at the last. Per-step losses
        and confusion matrices stay on the device: one host copy per
        epoch. With `devices` > 1 and no `mesh`, spawns the ranks and
        returns when they are done, with this Trainer's task, epoch and
        best metric those of rank 0."""
        if self.devices > 1 and self.mesh is None:
            return self._fit_ranks(train_loader, val_loader)
        step_fn = self.task.train_step
        np_rng = np.random.default_rng(self.seed)
        if self.mesh is not None:
            from .parallel.mesh import make_dp_train_step
            step_fn = make_dp_train_step(self.task, self.mesh)
            if self.mesh.rank:
                np_rng = np.random.default_rng([self.seed, self.mesh.rank])
        for epoch in range(self.epoch, self.max_epochs):
            self.epoch = epoch
            t0 = time.time()
            prep = 0.0
            clock = _StepClock(self.device)
            dev_losses, dev_cms = [], []
            for nags in self._own_batches(train_loader):
                tp = time.time()
                batch = nags if isinstance(nags, PaddedNAG) \
                    else self._to_device(prepare_batch(
                        nags, self.batch_cfg, train=True, rng=np_rng))
                prep += time.time() - tp
                clock.start()
                metrics = step_fn(batch)
                clock.stop()
                dev_losses.append(metrics['loss'])
                dev_cms.append(metrics['confmat'])
            cm = ConfusionMatrix(self.task.num_classes)
            losses = []
            if dev_losses:
                # one host copy: the losses, then the summed matrix
                host = torch.cat([
                    torch.stack(dev_losses).double(),
                    torch.stack(dev_cms).sum(0).double().flatten()]).cpu()
                losses = host[:len(dev_losses)].numpy()
                cm.merge(host[len(dev_losses):].numpy().round().reshape(
                    cm.confmat.shape))
            step_ms = clock.total_ms()
            m = cm.all_metrics()
            row = {'epoch': epoch, 'split': 'train',
                   'loss': float(np.mean(losses)) if len(losses) else None,
                   'miou': m['miou'], 'oa': m['oa'], 'macc': m['macc'],
                   'lr': self.task.lr_at(self.task.step),
                   'time': time.time() - t0}
            self.logger.log(row)
            loss_s = f"{row['loss']:.4f}" if row['loss'] is not None \
                else 'n/a'
            if self.is_main:
                print(f"[epoch {epoch}] train loss={loss_s} "
                      f"miou={m['miou']:.2f} ({row['time']:.1f}s)")

            stop = False
            tv = time.time()
            validated = self.is_main and val_loader is not None and (
                (epoch + 1) % self.check_val_every_n_epoch == 0
                or epoch == self.max_epochs - 1)
            if validated:
                vm = self.validate(val_loader)
                if self._panoptic_due(epoch):
                    vm = {**vm, **self.validate_panoptic(val_loader)}
                score = vm.get(self.monitor, vm['miou'])
                if self._plateau is not None and score is not None \
                        and self._plateau.step(score):
                    set_lr_multiplier(self.task, self._plateau.multiplier)
                    print(f'[epoch {epoch}] plateau: lr x '
                          f'{self._plateau.multiplier:g}')
                if score is not None and score > self.best_miou:
                    self.best_miou = score
                    self.save_checkpoint('best')
                    self._stale_validations = 0
                else:
                    self._stale_validations += 1
                    p = self.early_stopping_patience
                    if 0 < p <= self._stale_validations:
                        print(f'[epoch {epoch}] early stopping: '
                              f'{self.monitor} did not improve for '
                              f'{self._stale_validations} validations')
                        stop = True
            if self.is_main:
                self.save_checkpoint('last')
            if self.mesh is not None:
                # the other ranks wait here for rank 0's validation and
                # checkpoint, and take its decisions
                decided = [stop, self.task.lr_mult]
                dist.broadcast_object_list(decided, src=0,
                                           group=self.mesh.group)
                stop = decided[0]
                set_lr_multiplier(self.task, decided[1])
            self.epoch_times.append(dict(
                epoch=epoch, prepare_s=prep, step_ms=step_ms,
                steps=len(dev_losses),
                val_s=time.time() - tv if validated else None,
                wall_s=time.time() - t0))
            if stop:
                break

    def _own_batches(self, loader):
        """This process's loader items: all of them, or as rank r of D,
        items s * D + r of the complete groups of D (a port `DataLoader`
        loads only those)."""
        if self.mesh is None:
            yield from loader
            return
        D, r = self.devices, self.mesh.rank
        n = len(loader)
        if hasattr(loader, 'shard'):
            yield from loader.shard(r, D)
        else:
            for j, item in enumerate(islice(loader, n - n % D)):
                if j % D == r:
                    yield item
        if n % D and self.is_main:
            print(f'[epoch {self.epoch}] dropping {n % D} trailing '
                  f'batch(es) not filling the {D}-device group')

    def _fit_ranks(self, train_loader, val_loader):
        """Spawn the `devices` ranks (`_fit_rank`), each with a copy of
        this Trainer's fields, task and loaders, and take rank 0's trained
        task, epoch, best metric and epoch times."""
        from .parallel.multihost import run_ranks
        fields = {f.name: getattr(self, f.name)
                  for f in dataclasses.fields(self) if f.name != 'mesh'}
        progress = {k: getattr(self, k) for k in _PROGRESS}
        with tempfile.TemporaryDirectory(prefix='spt_fit_') as tmp:
            path = osp.join(tmp, 'fit.pt')
            torch.save({'fields': fields, 'progress': progress,
                        'loaders': (train_loader, val_loader)}, path)
            out = run_ranks(_fit_rank, self.devices,
                            args=(path, self.device.type))[0]
        self.task.load_state_dict(out.pop('task'))
        for k, v in out.items():
            setattr(self, k, v)

    def _panoptic_due(self, epoch):
        """The instance partition and PQ run on validation epochs that
        also hit the partition cadence."""
        n = self.partition_every_n_epoch
        if n is None or n <= 0:
            return False
        return (epoch + 1) % n == 0 or epoch == self.max_epochs - 1

    def validate_panoptic(self, loader, split='val', pq=None, ap=None):
        """Panoptic validation epoch (`validate_panoptic`), logged to
        panoptic.csv. The partition settings are grid-searched once and
        kept for the later validations. `pq` / `ap` accumulate across
        calls when given (6-fold)."""
        out = validate_panoptic(
            self.task, loader, self.eval_batch_cfg, self.task.num_classes,
            stuff_classes=self.stuff_classes,
            grid_search=(self.panoptic_grid_search
                         and self._partition_settings is None),
            settings=self._partition_settings, pq=pq, ap=ap)
        self._partition_settings = out.get('settings')
        if not hasattr(self, '_panoptic_logger'):
            self._panoptic_logger = CSVLogger(
                osp.join(self.output_dir, 'panoptic.csv'))
        scalars = {k: v for k, v in out.items()
                   if isinstance(v, (int, float))}
        self._panoptic_logger.log({'epoch': self.epoch, 'split': split,
                                   **scalars})
        msg = ' '.join(f'{k}={v:.2f}' for k, v in out.items()
                       if isinstance(v, float))
        print(f'[epoch {self.epoch}] {split} panoptic {msg}')
        return scalars

    def validate(self, loader, split='val', tta_runs=0):
        """One evaluation epoch. `tta_runs > 0`: per batch, the level-1
        logits of `tta_runs` augmented passes are added to the clean
        pass's before the argmax (needs lists of NAGs from a
        `DataLoader`). Returns the metrics with the raw `confmat`."""
        cm = ConfusionMatrix(self.task.num_classes)
        losses = []
        np_rng = np.random.default_rng(self.seed)
        for i_batch, nags in enumerate(loader):
            if isinstance(nags, PaddedNAG):
                if tta_runs > 0:
                    raise ValueError(
                        'TTA validation needs raw NAG batches (augmented '
                        're-preparation per run): use a DataLoader, not a '
                        'PreparedDataLoader')
                batch = nags
            else:
                batch = self._to_device(prepare_batch(
                    nags, self.eval_batch_cfg, train=False))
            out = self.task.eval_step(batch)
            losses.append(float(out['loss']))
            if tta_runs > 0:
                acc = out['logits_level1'].double().cpu().numpy()
                for _ in range(tta_runs):
                    b = self._to_device(prepare_batch(
                        nags, self.eval_batch_cfg, train=False, rng=np_rng,
                        tta=True))
                    acc += self.task.eval_step(b)['logits_level1'] \
                        .double().cpu().numpy()
                # the JAX Trainer's argmax reads the sums in f32
                cm.update(acc.astype(np.float32),
                          batch[1].y.cpu().numpy(),
                          node_mask=batch[1].node_mask.cpu().numpy())
            else:
                cm.merge(out['confmat'].cpu().numpy())
            if self.track_val_idx == -2 or i_batch == self.track_val_idx:
                self._track_batch(batch, out, split, i_batch)
        m = cm.all_metrics()
        self.logger.log({'epoch': self.epoch, 'split': split,
                         'loss': float(np.mean(losses)) if losses else None,
                         'miou': m['miou'], 'oa': m['oa'],
                         'macc': m['macc'], 'time': None})
        if self.logger.wants_figures:
            import matplotlib.pyplot as plt
            from .utils.wandb import confusion_matrix_figure
            fig = confusion_matrix_figure(cm.confmat)
            self.logger.log_figure(f'{split}/confusion_matrix', fig,
                                   step=self.epoch)
            plt.close(fig)
        print(f"[epoch {self.epoch}] {split} miou={m['miou']:.2f} "
              f"oa={m['oa']:.2f} macc={m['macc']:.2f}")
        # raw counts, so that callers can sum them across runs (6-fold)
        m['confmat'] = cm.confmat.copy()
        return m

    def _track_batch(self, batch, out, split, i_batch):
        """Dump one batch's level-1 logits, predictions, positions and
        label histograms to <output_dir>/predictions/."""
        d = osp.join(self.output_dir, 'predictions')
        os.makedirs(d, exist_ok=True)
        n1 = int(batch[1].num_nodes)
        logits = _numpy(out['logits_level1'])[:n1]
        payload = dict(logits=logits, pred=logits.argmax(-1),
                       pos=_numpy(batch[1].pos)[:n1])
        if batch[1].y is not None:
            payload['y_hist'] = _numpy(batch[1].y)[:n1]
        np.savez(osp.join(d, f'{split}_e{self.epoch}_b{i_batch}.npz'),
                 **payload)

    def test(self, loader):
        return self.validate(loader, split='test')


# what a rank's Trainer carries from one epoch to the next, beyond its task
_PROGRESS = ('epoch', 'best_miou', 'epoch_times', '_stale_validations',
             '_plateau', '_partition_settings')


def _fit_rank(rank, world_size, init_method, path, device_type):
    """One rank of `Trainer.fit` with `devices` > 1: rank r on `cuda:r`
    (NCCL) or the CPU (gloo). Loads the task onto its device (AdamW's
    step counts stay on the host, as `load_checkpoint` keeps them) and
    runs its share of `fit`; rank 0 returns the trained task's state and
    the Trainer's progress."""
    from .parallel.mesh import make_data_mesh
    device = torch.device('cuda', rank) if device_type == 'cuda' \
        else torch.device('cpu')
    if device.type == 'cuda':
        torch.cuda.set_device(device)
    mesh = make_data_mesh(device=device, init_method=init_method,
                          rank=rank, world_size=world_size)
    payload = torch.load(path, map_location=device, weights_only=False)
    task = payload['fields']['task']
    for state in task.optimizer.state.values():
        if torch.is_tensor(state.get('step')):
            state['step'] = state['step'].cpu()
    train_loader, val_loader = payload['loaders']
    for loader in (train_loader, val_loader):
        if hasattr(loader, 'device'):
            loader.device = device
    trainer = Trainer(**payload['fields'], mesh=mesh)
    for k, v in payload['progress'].items():
        setattr(trainer, k, v)
    trainer.fit(train_loader, val_loader)
    if rank:
        return None
    return {'task': task.state_dict(),
            **{k: getattr(trainer, k) for k in _PROGRESS}}


def _numpy(t):
    return t.detach().float().cpu().numpy() if t.is_floating_point() \
        else t.cpu().numpy()


def fit_partition(task, train_loader, batch_cfg, output_dir='outputs',
                  max_epochs=50, seed=0, node_cap=None, edge_cap=None):
    """EZ-SP's stage-1 loop: a `PartitionTask` (sparse-CNN embeddings,
    contrastive edge loss) over `prepare_partition_batch` batches of the
    level-0 voxels, on the device of the task's model. The capacities
    are those of the first batch unless given. Each epoch logs its mean
    loss and inter-edge count to `<output_dir>/metrics.csv` (the losses
    stay on the device: one host copy an epoch) and writes the
    checkpoints `last` and `best` (lowest loss) under
    `<output_dir>/checkpoints/`; an epoch without a single inter edge
    raises RuntimeError. Returns the `Trainer` that wrote them: its
    `task` is the trained task, its `epoch_times` the host batch
    preparation, the steps (CUDA events on a card) and the wall time of
    each epoch."""
    os.makedirs(output_dir, exist_ok=True)
    logger = CSVLogger(osp.join(output_dir, 'metrics.csv'))
    np_rng = np.random.default_rng(seed)
    trainer = Trainer(task=task, batch_cfg=batch_cfg,
                      output_dir=output_dir, max_epochs=max_epochs,
                      seed=seed)
    device = trainer.device

    example = prepare_partition_batch(
        next(iter(train_loader)), batch_cfg, train=True, rng=np_rng,
        node_cap=node_cap, edge_cap=edge_cap)
    if node_cap is None:
        node_cap = example.capacity
        edge_cap = example.edge_index.shape[1]
    del example

    best = np.inf
    for epoch in range(max_epochs):
        trainer.epoch = epoch
        t0 = time.time()
        prep = 0.0
        clock = _StepClock(device)
        dev_losses, dev_inter = [], []
        for nags in train_loader:
            tp = time.time()
            batch = prepare_partition_batch(
                nags, batch_cfg, train=True, rng=np_rng,
                node_cap=node_cap, edge_cap=edge_cap, device=device)
            prep += time.time() - tp
            clock.start()
            m = task.train_step(batch)
            clock.stop()
            dev_losses.append(m['loss'])
            dev_inter.append(m['n_inter_edge'])
        losses, inter = [], 0
        if dev_losses:
            # one host copy: the losses, then the summed inter-edge count
            host = torch.cat([
                torch.stack(dev_losses).double(),
                torch.stack(dev_inter).sum().double().reshape(1)]).cpu()
            losses = host[:-1].numpy()
            inter = int(host[-1])
        row = {'epoch': epoch, 'split': 'train',
               'loss': float(np.mean(losses)) if len(losses) else None,
               'n_inter_edge': inter, 'time': time.time() - t0}
        logger.log(row)
        print(f"[epoch {epoch}] partition loss={row['loss']:.4f} "
              f"inter_edges={inter} ({row['time']:.1f}s)")
        if inter == 0:
            raise RuntimeError(
                'fit_partition: no inter edge in a whole epoch; check the '
                'labels and the crops')
        trainer.save_checkpoint('last')
        if row['loss'] < best:
            best = row['loss']
            trainer.save_checkpoint('best')
        trainer.epoch_times.append(dict(
            epoch=epoch, prepare_s=prep, step_ms=clock.total_ms(),
            steps=len(dev_losses), val_s=None, wall_s=time.time() - t0))
    return trainer


def validate_panoptic(task, loader, batch_cfg, num_classes,
                      stuff_classes=(), grid_search=False, settings=None,
                      pq=None, ap=None):
    """Panoptic validation epoch of the `PanopticTask` `task`, on the
    device of its model: per batch of NAGs from `loader`, the evaluation
    forward, then on the host the instance partition of the predicted
    level-1 logits and edge affinities, matched against the gt
    InstanceData overlaps to accumulate PQ and mAP.

    Batches are prepared with `batch_cfg` (`instance=True`: the level-1
    instance graph) in evaluation mode and moved with their label
    histograms (`from_numpy(..., train=True)`), which the loss and its
    edge weights need; the NAGs carry `obj` InstanceData at level 1.
    Returns dict(pq, sq, rq, map_50, ...). `grid_search=True` searches
    the partition settings on the FIRST batch and reuses the best ones
    for the rest. `pq` and `ap` are accumulators to continue.
    """
    if pq is None:
        pq = PanopticQuality3D(num_classes, stuff_classes=stuff_classes)
    if ap is None:
        ap = MeanAveragePrecision3D(num_classes,
                                    stuff_classes=stuff_classes)
    if settings is None:
        settings = dict(regularization=10.0, x_weight=5e-2, cutoff=1)
    device = next(task.model.parameters()).device
    compute_dtype = task.model.net.compute_dtype
    first = True
    out_diag = {}
    for nags in loader:
        host = prepare_batch(nags, batch_cfg, train=False)
        batch = from_numpy(host, device, compute_dtype, train=True)
        out = task.eval_step(batch)
        lvl1 = batch[1]
        n1 = int(lvl1.num_nodes)
        logits = _numpy(out['logits_level1'])[:n1]
        ea = out.get('edge_affinity_logits')
        if ea is None or lvl1.obj_edge_index is None:
            continue
        emask = _numpy(lvl1.obj_edge_mask)
        ei = _numpy(lvl1.obj_edge_index)[:, emask]
        ea = _numpy(ea)[emask]
        pos = _numpy(lvl1.pos)[:n1]
        sizes = _numpy(lvl1.node_size)[:n1] \
            if lvl1.node_size is not None else None
        # gt overlaps from the host NAGs (level-1 InstanceData)
        objs = [nag[1].get('obj') for nag in nags]
        if any(o is None for o in objs):
            continue
        obj = objs[0] if len(objs) == 1 else _cat_instance(objs)
        # the batch's level 1 is sorted by parent: the logits, positions
        # and edges above are in batch order, `obj` in the host NAGs'
        # order. Reindex the gt overlaps into batch order.
        if batch.level1_node_id is not None:
            nid = batch.level1_node_id[:n1]
            if not np.array_equal(nid, np.arange(n1)):
                obj = obj[nid][0]

        if grid_search and first:
            settings, _, _ = grid_search_panoptic_partition(
                pos, logits, ei, ea, obj, num_classes,
                node_size=sizes, stuff_classes=stuff_classes)
            first = False
        obj_index = instance_partition(
            pos, logits, ei, ea, node_size=sizes,
            stuff_classes=stuff_classes, num_classes=num_classes,
            **settings)
        # diagnostics: how many instances the partition produced and how
        # well the predicted affinities separate the gt graph
        out_diag['n_pred_instances'] = (
            out_diag.get('n_pred_instances', 0)
            + int(obj_index.max()) + 1)
        if lvl1.obj_edge_affinity is not None:
            # counts accumulate across batches; fractions after the loop
            tgt = _numpy(lvl1.obj_edge_affinity)[emask]
            pred_pos = ea > 0.0
            gt_pos = tgt > 0.5
            out_diag['_ea_correct'] = (out_diag.get('_ea_correct', 0)
                                       + int((pred_pos == gt_pos).sum()))
            out_diag['_ea_gt_pos'] = (out_diag.get('_ea_gt_pos', 0)
                                      + int(gt_pos.sum()))
            out_diag['_ea_total'] = (out_diag.get('_ea_total', 0)
                                     + int(gt_pos.shape[0]))
        merged = obj.merge(obj_index)
        n_inst = int(obj_index.max()) + 1
        pred_sem = np.zeros(n_inst, np.int64)
        scores = np.zeros(n_inst)
        for i_ in range(n_inst):
            m = obj_index == i_
            s = logits[m].sum(0)
            pred_sem[i_] = s.argmax()
            p = np.exp(s - s.max())
            scores[i_] = (p / p.sum()).max()
        pq.update_from_instance_data(merged, pred_sem)
        ap.update_from_instance_data(merged, pred_sem, scores)
    out = pq.compute()
    out.update({f'map_{k}' if not k.startswith('map') else k: v
                for k, v in ap.compute().items()
                if k in ('map', 'map_50', 'map_25', 'mar')})
    # edge-affinity fractions from the accumulated counts
    ea_tot = out_diag.pop('_ea_total', 0)
    ea_correct = out_diag.pop('_ea_correct', 0)
    ea_gt_pos = out_diag.pop('_ea_gt_pos', 0)
    if ea_tot:
        out_diag['edge_affinity_acc'] = ea_correct / ea_tot
        out_diag['edge_affinity_gt_pos_frac'] = ea_gt_pos / ea_tot
    out.update(out_diag)
    out['settings'] = settings
    return out


def _cat_instance(objs):
    """Batch collation for gt overlaps (InstanceData.cat)."""
    return InstanceData.cat(objs)
