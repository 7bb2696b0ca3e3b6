"""Rank functions of the port's multi-process tests
(`tests/test_torch_parallel.py`). Each runs in a spawned process
(`parallel.multihost.run_ranks`), so this module imports neither jax nor
the JAX package: a rank imports only the port."""
import torch

from superpoint_transformer_torch.data.padded import from_numpy
from superpoint_transformer_torch.models.semantic import SemanticTask
from superpoint_transformer_torch.models.spt import SPT
from superpoint_transformer_torch.parallel import (
    all_gather_rows, all_reduce_max, all_reduce_min, all_reduce_sum,
    make_data_mesh, make_dp_train_step, make_shard_mesh,
    make_sharded_forward, make_sharded_train_step)

# the narrow SPT of the JAX package's sharded-attention test
NARROW = dict(point_mlp=(12, 16, 32), down_dim=(16, 16),
              down_in_mlp=((4 + 32, 16), (4 + 16, 16)), down_num_heads=2,
              down_num_blocks=1, up_dim=(16,), up_in_mlp=((4 + 16 + 16, 16),),
              h_edge_mlp=(18, 8), in_rpe_dim=8, qk_dim=2, no_ffn=True,
              k_rpe=True, q_rpe=True, v_rpe=True, use_diameter_parent=True,
              num_graphs=1)
# one AdamW step at lr 1e-3 (no warm-up) with the flagship's decay and
# attention LR scale
HPARAMS = dict(lr=1e-3, weight_decay=1e-2, transformer_lr_scale=0.1,
               total_steps=10, warmup_steps=0)


def narrow_task(state, shard_group=None, device='cpu'):
    """The narrow SPT's SemanticTask with the weights `state` ({state_dict
    key: numpy array})."""
    task = SemanticTask(SPT(shard_group=shard_group, device=device,
                            **NARROW), num_classes=13, **HPARAMS)
    task.model.load_state_dict({k: torch.from_numpy(v)
                                for k, v in state.items()})
    return task


def params(task):
    return {k: p.detach().cpu().numpy().copy()
            for k, p in task.model.named_parameters()}


def collectives(rank, world_size, init_method, xs, idx, cs):
    """Each collective on this rank's rows xs[rank]; gradients of
    sum_r <c_r, f(...)> through each (`cs[rank]` weights this rank's
    part of the objective)."""
    make_data_mesh(device='cpu', init_method=init_method, rank=rank,
                   world_size=world_size)
    group = torch.distributed.group.WORLD
    x = torch.tensor(xs[rank], requires_grad=True)
    c = torch.tensor(cs[rank])
    out = {'min': all_reduce_min(x, group).numpy(),
           'max': all_reduce_max(x, group).numpy()}
    s = all_reduce_sum(x * x, group)
    (s * c).sum().backward()
    out.update(sum=s.detach().numpy(), sum_grad=x.grad.numpy().copy())
    x.grad = None
    table = all_gather_rows(x * x, group)
    (table[torch.from_numpy(idx[rank])] * c[:idx.shape[1]]).sum().backward()
    out.update(gather=table.detach().numpy(),
               gather_grad=x.grad.numpy().copy())
    return out


def sharded(rank, world_size, init_method, shards, state):
    """The narrow SPT on this rank's shard: the sharded forward, then one
    sharded train step."""
    mesh = make_shard_mesh(device='cpu', init_method=init_method,
                           rank=rank, world_size=world_size)
    task = narrow_task(state, shard_group=mesh.group)
    batch = from_numpy(shards[rank], 'cpu', train=True)
    feats = make_sharded_forward(task.model.net, mesh)(batch)
    metrics = make_sharded_train_step(task, mesh)(batch)
    return {'feats': [f.numpy() for f in feats],
            'loss': float(metrics['loss']),
            'confmat': metrics['confmat'].numpy(), 'params': params(task)}


def data_parallel(rank, world_size, init_method, batches, state):
    """One data-parallel step of the narrow task on batch `rank`, and
    what the steps refuse."""
    mesh = make_data_mesh(device='cpu', init_method=init_method, rank=rank,
                          world_size=world_size)
    task = narrow_task(state)
    metrics = make_dp_train_step(task, mesh)(
        from_numpy(batches[rank], 'cpu', train=True))
    return {'loss': float(metrics['loss']),
            'confmat': metrics['confmat'].numpy(), 'params': params(task),
            'refused': refusals(mesh, state)}


def refusals(mesh, state):
    """{case: message} of what the data-parallel and sharded steps
    refuse, as the JAX package does: the panoptic task, and a model
    built for the other step."""
    from superpoint_transformer_torch.models.panoptic import PanopticTask
    refused = {}
    for name, make in (
            ('panoptic', lambda: PanopticTask(SPT(**NARROW),
                                              num_classes=13)),
            ('sharded_model', lambda: narrow_task(state,
                                                  shard_group=mesh.group))):
        try:
            make_dp_train_step(make(), mesh)
        except ValueError as e:
            refused[name] = str(e)
    try:
        make_sharded_train_step(narrow_task(state), mesh)
    except ValueError as e:
        refused['unsharded_model'] = str(e)
    return refused


def rehearsal(rank, world_size, init_method, name, args, constants):
    """`chip_smoke.<name>` as a rank on the CPU, with chip_smoke's
    `constants` set as the parent set them, the card-only calls stubbed
    and each CPU call of an attention entry point counted as a launch of
    its kernel (`test_torch_chip_smoke._rehearse_on_the_cpu`'s stubs, in
    this process)."""
    import chip_smoke
    for k, v in constants.items():
        setattr(chip_smoke, k, v)
    from superpoint_transformer_torch.nn import attention as block
    from superpoint_transformer_torch.ops import attention, attention_rpe
    torch.cuda.synchronize = lambda: None
    for fn_name, kernel in (('dense_attention_rpe',
                             attention_rpe.dense_attention_rpe),
                            ('dense_attention_trainable',
                             attention.dense_attention)):
        def counted(*a, _fn=getattr(block, fn_name), _kernel=kernel):
            _kernel.launches += 1
            return _fn(*a)
        setattr(block, fn_name, counted)
    return getattr(chip_smoke, name)(rank, world_size, init_method, *args)
