#!/usr/bin/env python3
"""Where SPT-3's bf16 training step on the kernels parts from the same
step on the plain attention: one step's loss and gradients on the
training batches that `chip_smoke.py`'s dataset phase holds (`hold_spt3`:
its synthetic raw files, configurations, batch seeds and weight seed),
over several weight seeds, in these variants of the attention:

- `f32`, `f32 plain`: the kernels, and the plain attention, in f32;
- `kernel`: K1's forward with its closed-form backward, in bf16 (the
  model's training route);
- `plain`: autograd through the plain attention, in bf16;
- `hybrid`: the plain forward with K1's closed-form backward, in bf16:
  against `plain` it isolates the backward formula, against `kernel`
  the kernel's forward;
- `plain+ulp`, `plain+ulp2`: the plain attention with each output entry
  moved by at most one f32 unit in the last place (two seeded sign
  patterns), in bf16: how far a difference of the kernel's own size in
  the attention's f32 output carries through the bf16 network;
- `plain+shuffled`: the plain attention plus the kernel's own difference
  from it on the same call (K1's forward minus the plain forward),
  shuffled over the output's entries by a seeded permutation, in bf16:
  a difference of the kernel's size and spread, at other places;
- `dk*1.01`, `f32 dk*1.01`: K1's closed-form backward with dk scaled by
  1.01, in bf16 and f32: what a 1% error in one gradient of the kernel
  route moves.

Prints, per dataset and weight seed, the relative L2 distance of the
gradients (all parameters flattened) and the relative loss difference of
each pair, and for the first seed the same by parameter group (stage,
block, head); holds every K1 call of the first bf16 step against the
plain version, forward and backward, at `chip_smoke.py`'s tolerances.
Writes everything to `chiprun_out/spt3_bf16_step.json`.

    python3 tools/spt3_bf16_step_cuda.py [--seeds 4] [--datasets dales,...]
    python3 tools/spt3_bf16_step_cuda.py --device cpu --points 20000

On the CPU the kernel route runs the plain forward (so `kernel` equals
`hybrid`), for a rehearsal at a small size.
"""
import argparse
import contextlib
import json
import os
import sys
import tempfile
import time

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

# (dataset, builtin config name, training clouds as (split, index))
PATHS = {'dales': ('DALES_CFG', [('train', 0), ('train', 1)]),
         'kitti360': ('KITTI360_CFG', [('train', 0)]),
         'scannet': ('PANOPTIC_SCANNET_CFG', [('train', 0), ('val', 0)])}
# the training batch's seed in `chip_smoke.py`'s `hold_spt3`, by dataset
BATCH_SEED = {'dales': 41, 'kitti360': 42, 'scannet': 44}
PAIRS = [('kernel', 'plain'), ('plain', 'f32'), ('kernel', 'f32'),
         ('hybrid', 'plain'), ('hybrid', 'kernel'), ('plain+ulp', 'plain'),
         ('plain+ulp2', 'plain+ulp'), ('plain+shuffled', 'plain'),
         ('dk*1.01', 'kernel'),
         ('f32 plain', 'f32'), ('f32 dk*1.01', 'f32')]


def group(name):
    """A parameter's group: its stage and block, its edge MLP or head."""
    parts = name.split('.')
    return '.'.join(parts[:3] if 'stage' in parts[1] else parts[:2])


@contextlib.contextmanager
def patched(obj, name, value):
    saved = getattr(obj, name)
    setattr(obj, name, value)
    try:
        yield
    finally:
        setattr(obj, name, saved)


def variant(name, dev):
    """A context in which the model's attention runs as variant `name`,
    and (compute dtype, plain_attention) of its task."""
    import torch
    from superpoint_transformer_torch.nn import attention as block
    from superpoint_transformer_torch.ops import attention as k1
    cd = None if name.startswith('f32') else 'bfloat16'
    if name == 'hybrid':
        class PlainForward(torch.autograd.Function):
            @staticmethod
            def forward(ctx, q, k, v, mask, scale):
                ctx.save_for_backward(q, k, v, mask, scale)
                return k1.dense_attention_reference(q, k, v, mask, scale)

            backward = k1._DenseAttention.backward
        return patched(block, 'dense_attention_trainable',
                       PlainForward.apply), cd, False
    if name.startswith('plain+ulp'):
        gen = torch.Generator().manual_seed(1 if name == 'plain+ulp' else 2)
        ref = k1.dense_attention_reference

        def moved(*args):
            out = ref(*args)
            sign = torch.randint(-1, 2, out.shape, generator=gen).to(dev)
            return out + sign * torch.finfo(torch.float32).eps * out.abs()
        return patched(block, 'dense_attention_reference', moved), cd, True
    if name == 'plain+shuffled':
        gen = torch.Generator().manual_seed(3)
        ref = k1.dense_attention_reference

        def shuffled(*args):
            out = ref(*args)
            with torch.no_grad():
                diff = (k1.dense_attention(*args) - out).flatten()
                perm = torch.randperm(diff.numel(), generator=gen)
            return out + diff[perm.to(dev)].view_as(out)
        return patched(block, 'dense_attention_reference', shuffled), cd, \
            True
    if name.endswith('dk*1.01'):
        bwd = k1.dense_attention_bwd

        def scaled(*args, **kwargs):
            dq, dk, dv, dscale = bwd(*args, **kwargs)
            return dq, (dk.float() * 1.01).to(dk.dtype), dv, dscale
        return patched(k1, 'dense_attention_bwd', scaled), cd, False
    return contextlib.nullcontext(), cd, name in ('plain', 'f32 plain')


def build(name, dev, root, points):
    """(config, training batch on the host) of dataset `name`, as
    `chip_smoke.py`'s dataset phase makes them."""
    import numpy as np
    import chip_smoke as cs
    from superpoint_transformer_torch import experiment
    from superpoint_transformer_torch.experiment import build_batch_config
    from superpoint_transformer_torch.transforms.prepare import prepare_batch
    cfg_name, clouds = PATHS[name]
    cfg = cs.spt3_cfg(getattr(experiment, cfg_name), dev,
                      os.path.join(root, name), os.path.join(root, 'out'),
                      mini=name == 'dales')
    datasets = cs.memory_datasets(cfg)
    t0 = time.perf_counter()
    for split in {s for s, _ in clouds}:
        datasets[split].process()
    nags = [datasets[s][i] for s, i in clouds]
    print(f'{name}: {len(nags)} clouds preprocessed in '
          f'{time.perf_counter() - t0:.2f} s; nodes per level '
          f'{[[n[j].num_nodes for j in n.levels] for n in nags]}')
    batch = prepare_batch(nags, build_batch_config(cfg), train=True,
                          rng=np.random.default_rng(cs.SEED
                                                    + BATCH_SEED[name]))
    return cfg, batch, len(nags)


def steps(cfg, host, graphs, dev, seed, names, keep_k1=None):
    """{variant: (loss, gradients flattened)} of one step from the
    weights of `seed`, and the parameter names."""
    import torch
    import chip_smoke as cs
    from superpoint_transformer_torch.data.padded import from_numpy
    from superpoint_transformer_torch.experiment import build_task
    from superpoint_transformer_torch.nn.mlp import init_weights
    out, params = {}, None
    for name in names:
        ctx, cd, plain = variant(name, dev)
        task = build_task(cfg, num_graphs=graphs, compute_dtype=cd,
                          plain_attention=plain, device=dev)
        init_weights(task.model, torch.Generator().manual_seed(seed))
        batch = from_numpy(host, dev, cd, train=True)
        keep = contextlib.nullcontext() if keep_k1 is None or name != \
            'kernel' else keep_k1
        with ctx, keep:
            out[name] = cs.loss_grads(task, batch)
        params = [(n, p.numel()) for n, p in task.model.named_parameters()]
        del task, batch
    return out, params


@contextlib.contextmanager
def every_k1_call(kept):
    """Keep the arguments (detached) of every K1 call while the block
    runs."""
    import torch
    from superpoint_transformer_torch.nn import attention as block
    fn = block.dense_attention_trainable

    def keeping(*args):
        kept.append([a.detach() if torch.is_tensor(a) else a for a in args])
        return fn(*args)

    with patched(block, 'dense_attention_trainable', keeping):
        yield kept


def compare(runs, params):
    """{pair: (loss rel, gradients rel L2)} and, by parameter group,
    {group: {pair: rel L2, '|g|': plain bf16 norm}}."""
    import chip_smoke as cs
    whole, by_group = {}, {}
    for a, b in PAIRS:
        if a in runs and b in runs:
            (la, ga), (lb, gb) = runs[a], runs[b]
            whole[f'{a} vs {b}'] = ((abs(la - lb) / lb.abs()).item(),
                                    cs.rel_l2(ga, gb))
    start = 0
    for name, n in params:
        g = by_group.setdefault(group(name), {'_slices': []})
        g['_slices'].append((start, start + n))
        start += n
    import torch
    for gname, g in by_group.items():
        idx = torch.cat([torch.arange(s, e) for s, e in g.pop('_slices')])
        g['|g|'] = runs['plain'][1][idx.to(runs['plain'][1].device)].norm() \
            .item()
        for a, b in PAIRS:
            if a in runs and b in runs:
                i = idx.to(runs[a][1].device)
                g[f'{a} vs {b}'] = cs.rel_l2(runs[a][1][i], runs[b][1][i])
    return whole, by_group


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split('\n\n')[0])
    ap.add_argument('--device', default='cuda')
    ap.add_argument('--seeds', type=int, default=4)
    ap.add_argument('--datasets', default='dales,kitti360,scannet')
    ap.add_argument('--points', type=int, default=None,
                    help='raw points per DALES tile and KITTI-360 window '
                         '(half per ScanNet scan); chip_smoke.py\'s sizes '
                         'by default')
    args = ap.parse_args(argv)
    sys.path.insert(0, HERE)
    import torch
    import chip_smoke as cs
    dev = torch.device(args.device)
    card = 'cpu'
    if dev.type == 'cuda':
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        from superpoint_transformer_torch.ops import cuda_build
        cuda_build.build()
        card = cs.card_line()
    if args.points:
        cs.DALES_TILE_POINTS = cs.KITTI360_WINDOW_POINTS = args.points
        cs.SCANNET_SCAN_POINTS = args.points // 2
    names = ['f32', 'f32 plain', 'kernel', 'plain', 'hybrid', 'plain+ulp',
             'plain+ulp2', 'plain+shuffled', 'dk*1.01', 'f32 dk*1.01']
    report = {'card': card, 'datasets': {}}
    with tempfile.TemporaryDirectory() as tmp:
        cs.write_dataset_roots(tmp)
        for name in args.datasets.split(','):
            cfg, host, graphs = build(name, dev, tmp, args.points)
            rows = []
            for i in range(args.seeds):
                seed = cs.SEED + i
                kept = []
                runs, params = steps(cfg, host, graphs, dev, seed, names,
                                     every_k1_call(kept) if i == 0 else None)
                whole, by_group = compare(runs, params)
                rows.append({'seed': seed, 'pairs': whole,
                             'loss': {k: v[0].item()
                                      for k, v in runs.items()}})
                print(f'{name} weight seed {seed} on {card}: ' + '; '.join(
                    f'{k}: loss rel {lv:.3e}, grads rel L2 {gv:.4g}'
                    for k, (lv, gv) in whole.items()), flush=True)
                if i == 0:
                    report.setdefault('groups', {})[name] = by_group
                    cols = [f'{a} vs {b}'
                            for a, b in PAIRS[:6] + PAIRS[7:8]]
                    print(f'{name} by group, weight seed {seed} (rel L2; '
                          f'columns: |g| plain, {", ".join(cols)}):')
                    for gname, g in by_group.items():
                        print(f'  {gname}: {g["|g|"]:.4g} ' + ' '.join(
                            f'{g[c]:.3g}' for c in cols))
                    for j, call in enumerate(kept):
                        cs.hold_on_path('K1', call, f'{name} step call {j}')
                del runs
            report['datasets'][name] = rows
    os.makedirs(os.path.join(HERE, 'chiprun_out'), exist_ok=True)
    with open(os.path.join(HERE, 'chiprun_out', 'spt3_bf16_step.json'),
              'w') as f:
        json.dump(report, f, indent=1)
    print(card)


if __name__ == '__main__':
    main()
