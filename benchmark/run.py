#!/usr/bin/env python3
"""Run one cell of the benchmark once, on the card of this machine.

    python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

from the root of a checkout. The cell's configuration, traffic, limits
and metrics are files under `benchmark/`, found by the names that
`BENCHMARK.json` gives (`harness/runner.py`). Set-up builds the program
and its weights from the seed, makes the cell's pool of host batches and
warms up every shape; the window then runs for `--seconds`; afterwards
the program's outputs are compared with the plain reference. With
`--trace 0` the result line carries the cell's end-to-end metrics, with
`--trace 1` its per-layer metrics, read from a profiled stretch of the
window.

The last line of standard output is one JSON object (`correct`,
`attempted`, `failed`, `metrics`, `device`, with `--trace 1` also
`breakdown`, and last the numbers compared with their limits under
`checks`); the last lines of standard error repeat those numbers.
Without a CUDA card, with fewer cards than the cell asks for, or with
JAX or the JAX package loaded once the window has closed, it prints no
result and exits non-zero.
"""
import argparse
import json
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FORBIDDEN = ('jax', 'jaxlib', 'flax', 'optax', 'orbax',
             'superpoint_transformer_tpu')
_T0 = time.perf_counter()


def process_age():
    """Seconds since this process started (its start time in /proc,
    else since this module was loaded)."""
    try:
        with open('/proc/self/stat') as f:
            start = int(f.read().rsplit(')', 1)[1].split()[19])
        with open('/proc/uptime') as f:
            up = float(f.read().split()[0])
        age = up - start / os.sysconf('SC_CLK_TCK')
        if age > 0:
            return age
    except (OSError, ValueError, IndexError):
        pass
    return time.perf_counter() - _T0


def _env():
    """Keep every build and kernel cache inside the checkout, at fixed
    paths, and keep libraries from loading JAX."""
    cache = os.path.join(ROOT, '.bench_cache')
    os.environ['TORCH_EXTENSIONS_DIR'] = os.path.join(cache, 'torch_ext')
    os.environ['TRITON_CACHE_DIR'] = os.path.join(cache, 'triton')
    os.environ['USE_FLAX'] = '0'
    os.environ['USE_JAX'] = '0'


def loaded_forbidden():
    return sorted({m.split('.', 1)[0] for m in list(sys.modules)}
                  & set(FORBIDDEN))


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split('\n')[0])
    ap.add_argument('--workload', required=True)
    ap.add_argument('--seed', type=int, required=True)
    ap.add_argument('--seconds', type=float, required=True)
    ap.add_argument('--trace', type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    with open(os.path.join(ROOT, 'BENCHMARK.json')) as f:
        bench = json.load(f)
    cells = {w['name']: w for w in bench['workloads']}
    if args.workload not in cells:
        print(f'run: no workload {args.workload!r}', file=sys.stderr)
        return 2
    _env()
    import torch
    need = int(cells[args.workload]['chips'])
    if not torch.cuda.is_available() or torch.cuda.device_count() < need:
        print(f'run: the cell needs {need} CUDA card(s); '
              f'{torch.cuda.device_count()} visible. Not run.',
              file=sys.stderr)
        return 3
    sys.path.insert(0, ROOT)
    from benchmark.harness.runner import run_cell
    result, lines = run_cell(bench, args.workload, args.seed, args.seconds,
                             args.trace, 'cuda:0', process_age)
    bad = loaded_forbidden()
    if bad:
        print(f'run: loaded {", ".join(bad)}, which the benchmark must '
              'not load. No result.', file=sys.stderr)
        return 4
    print('\n'.join(lines), file=sys.stderr, flush=True)
    print(json.dumps(result), flush=True)
    return 0


if __name__ == '__main__':
    sys.exit(main())
