#!/usr/bin/env python3
"""The readings that the limits of a panoptic serving cell
(`limits/<cell>.json`) are set from, at the cell's own size, on the
card, in one process, as `calibrate.py` reads a semantic cell's:

    python3 benchmark/calibrate_panoptic.py --workload <cell> \
        --seeds 1,2,3 [--control-seeds 4,5,6] [--faults 7,8,9] \
        [--only a,b] [--seconds 3]

- `--seeds`: sound runs of the program: their maximum is a limit's
  lower reading;
- `--control-seeds`: the control, the plain reference's panoptic answer
  computed in the precision below the configuration's (float8, e4m3
  values, for bf16) in the program's place, read against the float32
  reference: its minimum is the upper reading;
- `--faults`: each fault of `panoptic_faults.py` (or those named by
  `--only`) planted in the program.

Prints one JSON line a reading and writes them all to
`chiprun_out/calibrate_<cell>.jsonl`. `run.py` never runs any of this.
"""
import argparse
import json
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def control_numbers(cfg, traffic, seed, device):
    """The control's numbers on seed `seed`'s weights and pool."""
    import numpy as np
    import torch
    from benchmark.harness.instance_traffic import make_panoptic_pool
    from benchmark.harness.panoptic_check import panoptic_numbers
    from benchmark.harness.panoptic_weights import draw_panoptic_weights
    from benchmark.kinds.panoptic_serve import settings_of
    from benchmark.reference import panoptic as ref
    from benchmark.reference.spt import FP8_DTYPES
    weights = draw_panoptic_weights(cfg['model'], seed, device)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    settings, stuff = settings_of(cfg)
    pool, _ = make_panoptic_pool(cfg, traffic, seed)
    refs, answers = {}, []
    for b, host in enumerate(pool):
        refs[b] = ref.answer(cfg['model'], weights, host, settings, stuff,
                             device)
        low = ref.answer(cfg['model'], weights, host, settings, stuff,
                         device, FP8_DTYPES[0])
        nid = low['node_id']
        inst, cls = np.empty_like(nid), np.empty_like(nid)
        inst[nid], cls[nid] = low['instance'], low['cls']
        z = np.empty_like(low['logits'])
        z[nid] = low['logits']
        answers.append((b, (inst, cls, low['edge_affinity'], z)))
    return panoptic_numbers(refs, answers, settings, stuff)[0]


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
    import torch
    from benchmark import panoptic_faults
    from benchmark.calibrate import _seeds
    from benchmark.harness.check import judge
    from benchmark.harness.runner import cell_files
    from benchmark.kinds import panoptic_serve as kind
    with open(os.path.join(ROOT, 'BENCHMARK.json')) as f:
        bench = json.load(f)
    _, cfg, traffic, limits = cell_files(bench, args.workload)
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
             else panoptic_faults.FAULTS)
    for seed in _seeds(args.faults):
        for name in names:
            with panoptic_faults.plant(name):
                numbers, n, bad = program(seed)
            emit({'what': f'fault:{name}', 'seed': seed, 'numbers': numbers,
                  'attempted': n, 'failed': bad})
    return 0


if __name__ == '__main__':
    sys.exit(main())
