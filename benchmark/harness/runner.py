"""One run of one cell: find the cell's configuration, traffic, limits
and metrics by name, hand them to the traffic's kind
(`kinds/<kind>.py`), and turn what it records into the result line.

Everything that belongs to one configuration, traffic mix, cell or
metric sits in a file of its own that this module finds by the name
that `BENCHMARK.json` gives:

- `configs/<config>.json`: the model and its optimizer, as the
  reference reads them, and the program's configuration to build;
- `workloads/<traffic>.json`: the traffic's kind (`train` or `serve`),
  graphs a batch, level sizes and neighbor counts, pool size;
- `limits/<cell>.json`: the limit of each number compared;
- `metrics/<metric>.py`: a reader `read(run)` that returns the metric's
  value from the run's record, or None where it finds nothing to read.
"""
import importlib
import importlib.util
import json
import math
import os

import numpy as np

__all__ = ['BENCH_DIR', 'load_json', 'cell_files', 'metrics_of', 'reader',
           'run_cell']

BENCH_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def load_json(root, *parts):
    with open(os.path.join(root, *parts)) as f:
        return json.load(f)


def cell_files(bench, name, root=BENCH_DIR):
    """(cell entry, configuration, traffic, limits) of cell `name`, from
    the benchmark's directory `root`."""
    cells = {w['name']: w for w in bench['workloads']}
    if name not in cells:
        raise KeyError(f'no workload {name!r} in BENCHMARK.json')
    cell = cells[name]
    return (cell, load_json(root, 'configs', cell['config'] + '.json'),
            load_json(root, 'workloads', cell['traffic'] + '.json'),
            load_json(root, 'limits', name + '.json'))


def metrics_of(bench, name, per_layer):
    """The entries of the metrics that cell `name` reports: the
    end-to-end metrics whose `workloads` list it (or that have none); or
    the per-layer metrics whose `workloads` list it or, without the key,
    that move an end-to-end metric it reports."""
    e2e = [m for m in bench['end_to_end']
           if name in m.get('workloads', [name])]
    if not per_layer:
        return e2e
    moved = {m['name'] for m in e2e}
    return [m for m in bench['per_layer']
            if ('workloads' in m and name in m['workloads'])
            or ('workloads' not in m and m['moves'] in moved)]


def reader(name, root=BENCH_DIR):
    """The `read` function of metric `name`."""
    spec = importlib.util.spec_from_file_location(
        'benchmark_metric_' + name.replace('.', '_'),
        os.path.join(root, 'metrics', name + '.py'))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def _finite(x):
    return x if math.isfinite(x) else 1e300


def run_cell(bench, name, seed, seconds, trace, device, setup_clock,
             root=BENCH_DIR):
    """Run cell `name` once. Returns (result dict for the result line,
    the lines for standard error, the comparisons last)."""
    from .check import judge
    cell, cfg, traffic, limits = cell_files(bench, name, root)
    kind = importlib.import_module(f'benchmark.kinds.{traffic["kind"]}')
    run = kind.run(cfg, traffic, seed=seed, seconds=seconds,
                   trace=bool(trace), device=device,
                   setup_clock=setup_clock)
    checks, ok = judge(run['numbers'], limits)
    metrics = {}
    for m in metrics_of(bench, name, bool(trace)):
        value = reader(m['name'], root)(run)
        if value is not None:
            metrics[m['name']] = {'value': value, 'unit': m['unit']}
    dev = {'platform': run['platform'], 'kind': run['kind_name'],
           'count': int(cell['chips']),
           'memory_peak_bytes': int(run['memory_peak_bytes']),
           'power_limit': run['power_limit']}
    result = {'correct': bool(ok and run['failed'] == 0),
              'attempted': int(run['attempted']),
              'failed': int(run['failed']), 'metrics': metrics,
              'device': dev}
    if trace:
        t = run['trace']
        dev['busy_s'] = t.busy_s
        dev['window_s'] = t.window_s
        result['breakdown'] = {'device_ops': t.top_ops(),
                               'idle_gaps': t.idle_gaps()}
    result['checks'] = {k: {'value': _finite(v['value']),
                            'limit': v['limit']} for k, v in checks.items()}
    lines = []
    if run['latencies_s']:
        lat = 1e3 * np.asarray(run['latencies_s'])
        lines.append(f'latency over {lat.size} requests: median '
                     f'{np.median(lat):.3f} ms, p95 '
                     f'{np.percentile(lat, 95):.3f} ms, max {lat.max():.3f} ms')
    lines.append(f'window {run["window_s"]:.3f} s, {run["attempted"]} '
                 f'{"steps" if run["train"] else "requests"}, set-up '
                 f'{run["setup_s"]:.3f} s, card {run["kind_name"]} '
                 f'(power limit {run["power_limit"]})')
    lines.append(f'set-up split (s): {json.dumps(run["setup_split"])}')
    if run['train']:
        lines.append(f'losses of steps 1-3 {run["losses"]}, last step '
                     f'{run["final_loss"]!r}')
    lines += [f'recorded, not compared: {k} {v!r}'
              for k, v in run['numbers'].items() if k not in checks]
    lines += [f'check {k}: {v["value"]!r} (limit {v["limit"]!r})'
              for k, v in checks.items()]
    lines.append(f'check answers_failed: {run["failed"]} (limit 0)')
    return result, lines
