#!/usr/bin/env python3
"""Flagship serving forward and train step of two checkouts of the port,
on one CUDA card, in alternating rounds; with each round's device time by
op (torch.profiler) and a check that each checkout repeats itself bit for
bit.

    python3 tools/step_bench_cuda.py parent=<dir> change=<dir> [--rounds 2]

Each `<dir>` holds a `superpoint_transformer_torch/` package (e.g. the
parent commit unpacked with `git archive` into a git-ignored directory,
and `.`). The rounds run in the order parent, change, change, parent
(repeated `--rounds` times), each in a fresh process that imports the
package of its checkout, builds its kernels, and measures:

- the serving forward: SPT-2 on S3DIS (bf16, random weights from a seed)
  on 8 random padded graphs of one demo room each (`random_padded_nag`,
  as `chip_smoke.py` serves them), CUDA events over 10 forwards after 3
  warm-up, best of 3;
- the train step: `SemanticTask.train_step` on 4 random graphs at the
  4-crop caps (`train=True` batches: with the transpose neighbor tables
  where the checkout's `random_padded_nag` builds them), the same way;
- device time by kernel of 3 forwards and of 3 steps (torch.profiler,
  CUDA activity, device time summed by kernel name);
- reruns: the forward twice (logits) and a step's loss and gradients
  twice from the same weights, bit-equal or not, with the largest
  difference; where they differ, the first module (in call order) whose
  forward output differs, the parameters whose gradients differ and, for
  the change, the first aten op of the step (forward and backward) whose
  output differs between two runs (`first_diff_op`).

Prints one JSON line per round and a summary; writes everything to
`chiprun_out/step_bench.json`. The card's name and power limit are
printed beside the numbers.
"""
import json
import os
import subprocess
import sys
import time

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SEED = 0
ROOM = dict(n_points=41_500, n_l1=1_250, n_l2=350)
CROP = dict(n_points=41_000, n_l1=1_280, n_l2=500)
TOP_OPS = 12


def card_line():
    try:
        return subprocess.run(
            ['nvidia-smi', '--query-gpu=name,power.limit',
             '--format=csv,noheader'], capture_output=True,
            text=True).stdout.strip()
    except OSError:
        return 'nvidia-smi not found'


def cuda_ms(fn, iters=10, warmup=3, rounds=3):
    import torch
    for _ in range(warmup):
        fn()
    best = float('inf')
    for _ in range(rounds):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        torch.cuda.synchronize()
        a.record()
        for _ in range(iters):
            fn()
        b.record()
        torch.cuda.synchronize()
        best = min(best, a.elapsed_time(b) / iters)
    return best


def by_op(fn, iters=3):
    """Self device time (ms per call of `fn`) by op name, largest first,
    and the total."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    ops = {}
    for evt in prof.key_averages():
        t = getattr(evt, 'self_device_time_total', None)
        if t is None:
            t = getattr(evt, 'self_cuda_time_total', 0)
        if t > 0:
            name = evt.key[:70]
            ops[name] = ops.get(name, 0.0) + t / 1e3 / iters
    total = sum(ops.values())
    top = sorted(ops.items(), key=lambda kv: -kv[1])[:TOP_OPS]
    return total, [(k, round(v, 4)) for k, v in top]


def first_diff_module(model, run):
    """Name of the first module, in call order, whose forward output
    differs between two calls of `run`, or None."""
    import torch
    outs, order = [{}, {}], []

    def hook(name, k):
        def f(mod, inp, out):
            if torch.is_tensor(out):
                outs[k].setdefault(name, out.detach().clone())
                if k == 0 and name not in order:
                    order.append(name)
        return f

    for k in range(2):
        hs = [m.register_forward_hook(hook(n, k))
              for n, m in model.named_modules() if n]
        run()
        for h in hs:
            h.remove()
    for name in order:
        a, b = outs[0][name], outs[1].get(name)
        if b is None or not torch.equal(a, b):
            return name
    return None


def _bits_hash(t):
    """An exact hash of a tensor's bits and their positions (an integer
    sum, the same on every run), or None for an empty one."""
    import torch
    b = t.detach().contiguous().reshape(-1)
    if b.numel() == 0:
        return None
    if b.dtype == torch.bool:
        b = b.to(torch.int8)
    elif b.is_floating_point():
        b = b.view({8: torch.int64, 4: torch.int32,
                    2: torch.int16}[b.element_size()])
    w = torch.arange(b.numel(), device=b.device) % 65521 + 1
    return int((b.long() * w).sum())


def first_diff_op(run):
    """Run `run` twice under a dispatch mode that hashes the tensor
    inputs and outputs of every aten op (autograd's backward ops
    included); returns the first op whose outputs differ between the
    two runs, with whether its inputs were equal (an op that is not
    reproducible) or not (a difference that came from outside the
    recorded ops, e.g. a custom kernel), and the ops just before it."""
    import torch
    import torch.utils._pytree as pytree
    from torch.utils._python_dispatch import TorchDispatchMode

    class Record(TorchDispatchMode):
        def __init__(self):
            super().__init__()
            self.log = []

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            out = func(*args, **(kwargs or {}))
            ins = [_bits_hash(a) for a in pytree.tree_leaves((args, kwargs))
                   if torch.is_tensor(a)]
            outs = [_bits_hash(o) for o in pytree.tree_leaves(out)
                    if torch.is_tensor(o)]
            shapes = [tuple(o.shape) for o in pytree.tree_leaves(out)
                      if torch.is_tensor(o)]
            self.log.append((str(func), ins, outs, shapes))
            return out

    logs = []
    for _ in range(2):
        with Record() as rec:
            run()
        torch.cuda.synchronize()
        logs.append(rec.log)
    a, b = logs
    for i, (x, y) in enumerate(zip(a, b)):
        if x[0] != y[0]:
            return {'index': i, 'diverged_ops': [x[0], y[0]]}
        if x[2] != y[2]:
            return {'index': i, 'of': len(a), 'op': x[0], 'shapes': x[3],
                    'inputs_equal': x[1] == y[1],
                    'before': [e[0] for e in a[max(0, i - 6):i]]}
    return None


def worker(root, label):
    sys.path.insert(0, os.path.abspath(root))
    import torch
    import superpoint_transformer_torch as port
    assert os.path.abspath(port.__file__).startswith(os.path.abspath(root))
    from superpoint_transformer_torch.data.padded import from_numpy
    from superpoint_transformer_torch.experiment import (
        FLAGSHIP_CFG, build_model, build_task)
    from superpoint_transformer_torch.models.semantic import (
        SemanticSegmentationModel)
    from superpoint_transformer_torch.nn.mlp import init_weights
    from superpoint_transformer_torch.ops import cuda_build
    from superpoint_transformer_torch.utils.synthetic import (
        random_padded_nag)

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device('cuda', 0)
    cuda_build.build()
    res = {'label': label, 'root': root}

    # serving forward
    model = SemanticSegmentationModel(build_model(
        FLAGSHIP_CFG, num_graphs=8, device=dev), 13, device=dev)
    init_weights(model, torch.Generator().manual_seed(SEED))
    model.eval()
    cd = model.net.compute_dtype
    batch = from_numpy(random_padded_nag(seed=SEED + 1, num_graphs=8,
                                         **ROOM), dev, cd)

    def forward():
        with torch.inference_mode():
            return model(batch)

    res['forward_ms'] = cuda_ms(forward)
    res['forward_device_ms'], res['forward_ops'] = by_op(forward)
    a, b = forward(), forward()
    res['forward_bit_equal'] = all(torch.equal(x, y) for x, y in zip(a, b))
    res['forward_max_diff'] = max((x - y).abs().max().item()
                                  for x, y in zip(a, b))
    if not res['forward_bit_equal']:
        with torch.no_grad():
            res['forward_first_diff'] = first_diff_module(
                model, lambda: model(batch))
    del model, batch

    # train step
    task = build_task(FLAGSHIP_CFG, num_graphs=4, device=dev)
    init_weights(task.model, torch.Generator().manual_seed(SEED))
    host = random_padded_nag(seed=SEED + 10, num_graphs=4, **CROP)
    tb = from_numpy(host, dev, cd, train=True)
    res['transpose_tables'] = tb[1].nbr_in_idx is not None
    start = {k: v.detach().clone()
             for k, v in task.model.state_dict().items()}

    def grads():
        task.model.train()
        task.optimizer.zero_grad(set_to_none=True)
        loss, _ = task.loss(tb)
        loss.backward()
        return loss.detach(), {n: p.grad.detach().clone()
                               for n, p in task.model.named_parameters()
                               if p.grad is not None}

    (l1, g1), (l2, g2) = grads(), grads()
    diff = [n for n in g1 if not torch.equal(g1[n], g2[n])]
    res['step_loss_bit_equal'] = bool(torch.equal(l1, l2))
    res['step_grads_bit_equal'] = not diff
    res['step_grad_max_diff'] = max((g1[n] - g2[n]).abs().max().item()
                                    for n in g1)
    res['step_grad_diff_params'] = diff[:8]
    res['step_grad_diff_count'] = f'{len(diff)} of {len(g1)}'
    if not res['step_loss_bit_equal'] or diff:
        task.model.train()
        res['step_forward_first_diff'] = first_diff_module(
            task.model, lambda: task.loss(tb))
        if label == 'change':
            res['step_first_diff_op'] = first_diff_op(grads)
    task.model.load_state_dict(start)
    res['step_ms'] = cuda_ms(lambda: task.train_step(tb))
    res['step_device_ms'], res['step_ops'] = by_op(
        lambda: task.train_step(tb))
    res['peak_gib'] = torch.cuda.max_memory_allocated() / 2**30
    print(json.dumps(res), flush=True)


def main(argv):
    if argv[:1] == ['--worker']:
        return worker(argv[1], argv[2])
    rounds = 2
    roots = {}
    i = 0
    while i < len(argv):
        if argv[i] == '--rounds':
            rounds = int(argv[i + 1])
            i += 2
            continue
        k, _, v = argv[i].partition('=')
        roots[k] = os.path.abspath(v)
        i += 1
    if set(roots) != {'parent', 'change'}:
        sys.exit('usage: step_bench_cuda.py parent=<dir> change=<dir> '
                 '[--rounds N]')
    card = card_line()
    print(f'card: {card}', flush=True)
    results = []
    for _ in range(rounds):
        for label in ('parent', 'change', 'change', 'parent'):
            t0 = time.perf_counter()
            out = subprocess.run(
                [sys.executable, os.path.abspath(__file__), '--worker',
                 roots[label], label], capture_output=True, text=True,
                cwd=roots[label])
            if out.returncode:
                print(out.stdout[-4000:], out.stderr[-4000:])
                sys.exit(f'{label} round failed')
            res = json.loads(out.stdout.strip().splitlines()[-1])
            res['wall_s'] = time.perf_counter() - t0
            results.append(res)
            print(json.dumps(res), flush=True)
    summary = {}
    for label in ('parent', 'change'):
        rs = [r for r in results if r['label'] == label]
        summary[label] = {k: [round(r[k], 4) for r in rs] for k in (
            'forward_ms', 'step_ms', 'forward_device_ms', 'step_device_ms')}
        summary[label]['bit_equal'] = [
            (r['forward_bit_equal'], r['step_loss_bit_equal'],
             r['step_grads_bit_equal']) for r in rs]
    print(f'summary on {card}: {json.dumps(summary)}', flush=True)
    os.makedirs(os.path.join(HERE, 'chiprun_out'), exist_ok=True)
    with open(os.path.join(HERE, 'chiprun_out', 'step_bench.json'),
              'w') as f:
        json.dump({'card': card, 'rounds': results, 'summary': summary},
                  f, indent=1)


if __name__ == '__main__':
    main(sys.argv[1:])
