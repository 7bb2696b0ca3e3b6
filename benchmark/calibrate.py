#!/usr/bin/env python3
"""The readings that the limits of `limits/<cell>.json` are set from, at
a cell's own size, on the card, in one process:

    python3 benchmark/calibrate.py --workload <cell> --seeds 1,2,3 \
        [--control-seeds 4,5,6] [--faults 7,8,9] [--only a,b] \
        [--seconds 3]

- for each of `--seeds`, a sound run of the program (a window of
  `--seconds`) and its numbers: their maximum is a limit's lower reading;
- for each of `--control-seeds`, the control: the plain reference put in
  the program's place and computed in the precision below the
  configuration's (for bf16, float8: e4m3 values, e5m2 gradients),
  read against the float32 reference by the same numbers: their minimum
  is the upper reading;
- for each of `--faults`, each fault of `faults.py` that the cell's
  check has to fail (or those named by `--only`) planted in the program,
  read the same way.

Prints one JSON line a reading and writes them all to
`chiprun_out/calibrate_<cell>.jsonl`. `run.py` never runs any of this.
"""
import argparse
import json
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _seeds(text):
    return [int(s) for s in text.split(',') if s] if text else []


def control_numbers(cfg, traffic, seed, device):
    """The control's numbers on seed `seed`'s weights and pool."""
    import torch
    from benchmark.harness.check import serve_numbers, train_numbers
    from benchmark.harness.common import make_pool
    from benchmark.harness.weights import draw_weights
    from benchmark.reference.spt import FP8_DTYPES
    qdt = FP8_DTYPES[0]
    weights = draw_weights(cfg['model'], seed, device)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    if traffic['kind'] == 'serve':
        from benchmark.kinds.serve import node_graphs, reference_logits
        pool, _ = make_pool(cfg, traffic, seed, train=False)
        ref, graphs, answers = {}, {}, []
        for b, host in enumerate(pool):
            ref[b] = reference_logits(cfg, host, weights, device)
            graphs[b] = node_graphs(host)
            low = reference_logits(cfg, host, weights, device, qdt)
            answers.append((b, low.argmax(1)))
        return serve_numbers(ref, graphs, answers)[0]
    from benchmark.kinds.train import reference_steps
    pool, _ = make_pool(cfg, traffic, seed, train=True)
    ref = reference_steps(cfg, pool, weights, device)
    low = reference_steps(cfg, pool, weights, device, qdt)
    return train_numbers(*low, *ref)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split('\n')[0])
    ap.add_argument('--workload', required=True)
    ap.add_argument('--seeds', default='')
    ap.add_argument('--control-seeds', default='')
    ap.add_argument('--faults', default='')
    ap.add_argument('--only', default='')
    ap.add_argument('--seconds', type=float, default=3.0)
    args = ap.parse_args(argv)
    sys.path.insert(0, ROOT)
    import importlib
    import torch
    from benchmark import faults
    from benchmark.harness.check import judge
    from benchmark.harness.runner import cell_files
    with open(os.path.join(ROOT, 'BENCHMARK.json')) as f:
        bench = json.load(f)
    cell, cfg, traffic, limits = cell_files(bench, args.workload)
    kind = importlib.import_module(f'benchmark.kinds.{traffic["kind"]}')
    out_dir = os.path.join(ROOT, 'chiprun_out')
    os.makedirs(out_dir, exist_ok=True)
    path = os.path.join(out_dir, f'calibrate_{args.workload}.jsonl')
    t0 = time.perf_counter()

    def emit(rec):
        rec['ok'] = judge(rec['numbers'], limits)[1]
        rec['elapsed_s'] = round(time.perf_counter() - t0, 3)
        line = json.dumps(rec)
        print(line, flush=True)
        with open(path, 'a') as f:
            f.write(line + '\n')

    def program(seed):
        run = kind.run(cfg, traffic, seed=seed, seconds=args.seconds,
                       trace=False, device='cuda:0',
                       setup_clock=lambda: 0.0)
        return run['numbers'], run['attempted'], run['failed']

    for seed in _seeds(args.seeds):
        numbers, n, bad = program(seed)
        emit({'what': 'program', 'seed': seed, 'numbers': numbers,
              'attempted': n, 'failed': bad})
    for seed in _seeds(args.control_seeds):
        emit({'what': 'control', 'seed': seed,
              'numbers': control_numbers(cfg, traffic, seed,
                                         torch.device('cuda:0'))})
    names = ([n for n in args.only.split(',') if n] if args.only
             else faults.FAULTS[traffic['kind']])
    for seed in _seeds(args.faults):
        for name in names:
            with faults.plant(name):
                numbers, n, bad = program(seed)
            emit({'what': f'fault:{name}', 'seed': seed, 'numbers': numbers,
                  'attempted': n, 'failed': bad})
    return 0


if __name__ == '__main__':
    sys.exit(main())
