"""Data-parallel and graph-partition-parallel steps over
`torch.distributed`; the counterpart of `superpoint_transformer_tpu/
parallel/mesh.py`, with its names.

A JAX mesh is a set of devices driven by one program; here a `Mesh` is
one rank's view of a process group (the group, this rank, the group's
size, this rank's device): one process a rank, each on its own batch or
shard. So JAX's `stack_batches` / `shard_batch` become "rank r takes
batch r", and every step below is called by every rank of the group.

- `make_dp_train_step`: each rank its own batch; gradients and losses
  are averaged over the ranks (`pmean`), confusion matrices summed, and
  every rank takes the same AdamW update of its replicated parameters.
- `make_sharded_train_step` / `make_sharded_forward`: the nodes of one
  batch split over the ranks (`shard_nag.py`), the model built with the
  group as `shard_group` (norm statistics and k/v rows cross the ranks).
  The loss is the unsharded one on every rank; the gradients are
  averaged, which gives the unsharded gradient (see
  `models/semantic.py:SemanticTask._group_step`; JAX's `psum` of them is
  world-size times it).

The gradients are averaged by one all-reduce of one flat bucket after the
backward (`collectives.all_reduce_mean_`), not by
`DistributedDataParallel`: the sharded step's backward runs the
collectives' own all-reduces, and with DDP's bucket hooks firing in the
same backward the order of the two kinds would have to match on every
rank; one bucket after the backward is one collective a step in a fixed
order, and the optimizer's groups keep their parameter names.

A group on CUDA devices uses NCCL, one card a rank; on the CPU, gloo.
Two ranks may share one card over gloo (a correctness run: NCCL refuses
two ranks on one device).
"""
import datetime
from dataclasses import dataclass

import torch
import torch.distributed as dist

from .collectives import all_gather_rows

__all__ = ['Mesh', 'make_data_mesh', 'make_dp_train_step',
           'make_shard_mesh', 'make_sharded_forward',
           'make_sharded_train_step']

# How long a collective waits for the slowest rank. In the data-parallel
# Trainer the other ranks wait in a broadcast while rank 0 validates (TTA
# included) and writes its checkpoints; NCCL's default watchdog (10
# minutes) would end a run whose validation takes longer.
GROUP_TIMEOUT = datetime.timedelta(hours=4)


@dataclass
class Mesh:
    """One rank's view of a process group: the group, this rank, the
    number of ranks, this rank's device."""
    group: object
    rank: int
    size: int
    device: torch.device


def _make_mesh(fn, device, backend, init_method, rank, world_size):
    if not dist.is_initialized():
        if init_method is None or rank is None or world_size is None:
            raise ValueError(f'{fn}: no process group yet; give '
                             'init_method, rank and world_size')
        device = torch.device('cuda', rank) if device is None \
            else torch.device(device)
        # NCCL on CUDA devices, gloo on the CPU
        backend = backend or ('nccl' if device.type == 'cuda' else 'gloo')
        dist.init_process_group(backend, init_method=init_method,
                                rank=int(rank), world_size=int(world_size),
                                timeout=GROUP_TIMEOUT)
    elif backend is not None and backend != dist.get_backend():
        raise ValueError(f'{fn}: the process group runs '
                         f'{dist.get_backend()}, not {backend}')
    rank = dist.get_rank()
    device = torch.device('cuda', rank) if device is None \
        else torch.device(device)
    if device.type == 'cuda' and not torch.cuda.is_available():
        raise RuntimeError(f'{fn}: no CUDA device; pass device="cpu" to run '
                           'the ranks on the CPU')
    return Mesh(group=dist.group.WORLD, rank=rank,
                size=dist.get_world_size(), device=device)


def make_data_mesh(device=None, backend=None, init_method=None, rank=None,
                   world_size=None):
    """This rank's data-parallel `Mesh`. Joins the process group first
    when there is none (`init_method`, e.g. 'file://<path>' or
    'tcp://localhost:<port>', `rank`, `world_size`; `backend` by
    default NCCL on CUDA, gloo on the CPU). `device` defaults to
    `cuda:<rank>`."""
    return _make_mesh('make_data_mesh', device, backend, init_method, rank,
                      world_size)


def make_shard_mesh(device=None, backend=None, init_method=None, rank=None,
                    world_size=None):
    """This rank's `Mesh` for graph-partition sharding (as
    `make_data_mesh`)."""
    return _make_mesh('make_shard_mesh', device, backend, init_method, rank,
                      world_size)


def make_dp_train_step(task, mesh):
    """The data-parallel train step of a `SemanticTask` on `mesh`:
    `step(batch)`, called by every rank with its own batch, returns
    {'loss': the mean of the ranks' losses, 'confmat': their sum} and
    leaves every rank's task with the same update of the mean
    gradient. Raises ValueError where the task refuses the step
    (`SemanticTask.check_group_step`)."""
    task.check_group_step(mesh.group)

    def step(batch):
        return task.train_step(batch, group=mesh.group)

    return step


def make_sharded_train_step(task, mesh):
    """The graph-partition-parallel train step: every rank calls
    `step(batch)` with its shard of one batch (`shard_padded_nag`); the
    model must be built with `shard_group=mesh.group`. Returns {'loss':
    the unsharded loss, 'confmat': the summed confusion matrix}; every
    rank takes the unsharded step's update."""
    task.check_group_step(mesh.group, sharded=True)

    def step(batch):
        return task.train_step(batch, group=mesh.group, sharded=True)

    return step


def make_sharded_forward(model, mesh, train=False):
    """The graph-partition-parallel forward of `model` (built with
    `shard_group=mesh.group`; an SPT, or a model that returns a list of
    per-level [N_i, C] tensors): every rank calls `fwd(batch)` with its
    shard, and every rank gets each level's output of all ranks,
    concatenated in rank order ([size * capacity_i, C]: JAX's
    `out_specs=P('shard')`). Without `train` it runs in evaluation mode
    without autograd."""
    net = getattr(model, 'net', model)
    if getattr(net, 'shard_group', None) is not mesh.group:
        raise ValueError('make_sharded_forward: build the model with '
                         'shard_group=mesh.group')

    def fwd(batch):
        model.train(train)
        with torch.set_grad_enabled(train):
            return [all_gather_rows(x, mesh.group) for x in model(batch)]

    return fwd
