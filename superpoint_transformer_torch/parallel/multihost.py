"""Multi-process ranks: the launcher the data-parallel Trainer and the
tests use (`run_ranks`), and the multi-host dry run, the counterpart of
`superpoint_transformer_tpu/parallel/multihost.py`.

JAX runs one process a host, each driving its host's devices, joined by
`jax.distributed.initialize`. A torch process drives one rank, so here a
"host" of the dry run is a set of `n_dev // n_proc` rank processes: the
global rank picks the data (the batch of global slot g is seeded with g,
so the global batch does not depend on the process count) and the local
rank the device. The dry run is CPU and gloo only, as JAX's is.

Ranks are started with the `spawn` method: each imports the package
afresh (never a fork of a process that holds a CUDA context), runs a
function of the package, and reports its result through a file. A rank
that raises or dies fails the launch, and the others are stopped.
"""
import os
import os.path as osp
import shutil
import socket
import tempfile
import time
import traceback

import numpy as np

__all__ = ['run_ranks', 'make_global_batch', 'worker_main',
           'launch_multihost_dryrun']


def _rank_entry(fn, rank, world_size, init_method, args, out_dir, env,
                threads):
    os.environ.update(env)
    import torch
    torch.set_num_threads(threads)
    try:
        result = fn(rank, world_size, init_method, *args)
        torch.save(result, osp.join(out_dir, f'rank{rank}.pt'))
    except BaseException:
        with open(osp.join(out_dir, f'rank{rank}.err'), 'w') as f:
            f.write(traceback.format_exc())
        raise
    finally:
        import torch.distributed as dist
        if dist.is_initialized():
            dist.destroy_process_group()


def run_ranks(fn, world_size, args=(), timeout=None, init_method=None):
    """Run `fn(rank, world_size, init_method, *args)` in `world_size`
    spawned processes and return their results in rank order. `fn` is a
    module-level function (spawn imports it) that joins the group itself,
    e.g. through `mesh.make_data_mesh(init_method=..., rank=...,
    world_size=...)`; `init_method` defaults to a file store in a fresh
    temporary directory. Every rank runs gloo on the loopback interface
    (`GLOO_SOCKET_IFNAME=lo`): the ranks share one host. The ranks share
    this process's intra-op threads (`torch.get_num_threads()`). Raises
    RuntimeError, with the rank's traceback, when a rank fails, and
    TimeoutError when they are not done within `timeout` seconds; every
    rank is stopped in both cases."""
    import multiprocessing as mp
    import torch
    out_dir = tempfile.mkdtemp(prefix='spt_ranks_')
    if init_method is None:
        init_method = 'file://' + osp.join(out_dir, 'store')
    env = {'GLOO_SOCKET_IFNAME': 'lo'}
    ctx = mp.get_context('spawn')
    threads = max(1, torch.get_num_threads() // world_size)
    procs = [ctx.Process(target=_rank_entry, args=(
        fn, r, world_size, init_method, tuple(args), out_dir, env, threads))
        for r in range(world_size)]
    try:
        for p in procs:
            p.start()
        deadline = None if timeout is None else time.monotonic() + timeout
        while any(p.is_alive() for p in procs):
            failed = [r for r, p in enumerate(procs)
                      if p.exitcode not in (None, 0)]
            if failed:
                raise RuntimeError(_failure(failed, procs, out_dir))
            if deadline is not None and time.monotonic() > deadline:
                raise TimeoutError(f'ranks not done in {timeout} s')
            time.sleep(0.05)
        failed = [r for r, p in enumerate(procs) if p.exitcode != 0]
        if failed:
            raise RuntimeError(_failure(failed, procs, out_dir))
        return [torch.load(osp.join(out_dir, f'rank{r}.pt'),
                           map_location='cpu', weights_only=False)
                for r in range(world_size)]
    finally:
        for p in procs:
            if p.is_alive():
                p.terminate()
        for p in procs:
            if p.pid is not None:
                p.join(timeout=10)
                if p.is_alive():
                    p.kill()
                    p.join()
        shutil.rmtree(out_dir, ignore_errors=True)


def _failure(failed, procs, out_dir):
    msgs = []
    for r in failed:
        err = osp.join(out_dir, f'rank{r}.err')
        tb = open(err).read() if osp.exists(err) else '(no traceback)'
        msgs.append(f'rank {r} exited with code {procs[r].exitcode}:\n{tb}')
    return '\n'.join(msgs)


def make_global_batch(local_batches, mesh, compute_dtype=None):
    """This rank's part of the global batch: its one padded batch
    (numpy leaves, label histograms kept) as tensors on the rank's
    device. JAX assembles a process's batches for all its devices into
    one global array; a torch process is one rank and holds one."""
    from ..data.padded import from_numpy
    if len(local_batches) != 1:
        raise ValueError(f'a rank takes one batch, got {len(local_batches)}')
    return from_numpy(local_batches[0], mesh.device, compute_dtype,
                      train=True)


def dryrun_batch(g):
    """The padded batch of global slot `g`: `random_nag(seed=g)` of 512
    points, prepared for evaluation (no sampling), with its label
    histograms."""
    from ..transforms.prepare import BatchConfig, prepare_batch
    from ..utils.synthetic import random_nag
    cfg = BatchConfig(sample_graph_r=-1, sample_segment_ratio=0)
    return prepare_batch([random_nag(seed=g, n_points=512)], cfg,
                         train=False, rng=np.random.default_rng(g))


def dryrun_task():
    """The dry run's task, on the CPU: the flagship SemanticTask
    (FLAGSHIP_CFG, one graph a batch, 100 steps, 10 of warm-up) with
    weights drawn from torch's generator seeded with 0, so every rank
    builds the same."""
    import copy
    import torch
    from ..experiment import FLAGSHIP_CFG, build_task
    cfg = copy.deepcopy(FLAGSHIP_CFG)
    cfg['model']['scheduler']['num_warmup'] = 10
    torch.manual_seed(0)
    return build_task(cfg, num_graphs=1, total_steps=100, device='cpu')


def worker_main(rank, world_size, init_method, n_proc):
    """One rank of the dry run: join the group (gloo on the CPU), take
    the batch of global slot `rank`, run ONE global data-parallel train
    step of the flagship task, and return {loss, confmat, rank, host,
    local rank}."""
    from .mesh import make_data_mesh, make_dp_train_step
    per_host = world_size // n_proc
    mesh = make_data_mesh(device='cpu', init_method=init_method, rank=rank,
                          world_size=world_size)
    task = dryrun_task()
    batch = make_global_batch([dryrun_batch(rank)], mesh,
                              task.model.net.compute_dtype)
    metrics = make_dp_train_step(task, mesh)(batch)
    return {'rank': rank, 'host': rank // per_host,
            'local_rank': rank % per_host,
            'world_size': world_size, 'loss': float(metrics['loss']),
            'confmat': metrics['confmat'].cpu().numpy()}


def _free_port():
    s = socket.socket()
    s.bind(('localhost', 0))
    port = s.getsockname()[1]
    s.close()
    return port


def launch_multihost_dryrun(n_proc=2, n_dev=4, timeout=900.0):
    """`n_proc` "hosts" x `n_dev // n_proc` ranks, one process a rank,
    joined over TCP on a free localhost port, run one global
    data-parallel train step on the CPU over gloo. Returns the ranks' results; raises when a
    rank fails or the ranks disagree on the loss or the confusion
    matrix."""
    if n_dev % n_proc:
        raise ValueError(f'n_dev={n_dev} is not a multiple of '
                         f'n_proc={n_proc}')
    results = run_ranks(worker_main, n_dev, args=(n_proc,),
                        timeout=timeout,
                        init_method=f'tcp://localhost:{_free_port()}')
    losses = [r['loss'] for r in results]
    if not all(np.isfinite(losses)):
        raise RuntimeError(f'non-finite dry-run loss: {losses}')
    if max(losses) != min(losses) or any(
            not np.array_equal(r['confmat'], results[0]['confmat'])
            for r in results):
        raise RuntimeError(f'the ranks disagree: {results}')
    return results
