"""Helpers of the benchmark's tests: a copy of the benchmark's data files
with the traffic cut to a size that a CPU test holds."""
import json
import os
import shutil
import time

from benchmark.harness.runner import BENCH_DIR

REPO = os.path.dirname(BENCH_DIR)


def bench():
    with open(os.path.join(REPO, 'BENCHMARK.json')) as f:
        return json.load(f)


def tiny_traffic(t, graphs=2):
    """Traffic `t` cut to at most ~2,000 level-0 nodes a graph (a
    hundredth at least), 2 graphs and short neighbor lists."""
    t = json.loads(json.dumps(t))
    cut = max(100.0, t['levels'][0]['nodes'] / 2000)
    for lvl in t['levels']:
        lvl['nodes'] = max(int(lvl['nodes'] / cut), 12)
        if 'degree_mean' in lvl:
            lvl['degree_mean'], lvl['degree_max'] = 6, 11
    t['graphs'], t['trace_steps'] = graphs, 2
    return t


def tiny_root(tmp_path):
    """A copy of the benchmark's configs, traffic, limits and metrics
    under `tmp_path`, every traffic cut by `tiny_traffic`."""
    root = str(tmp_path / 'bench')
    for d in ('configs', 'metrics', 'limits', 'workloads'):
        shutil.copytree(os.path.join(BENCH_DIR, d), os.path.join(root, d))
    wdir = os.path.join(root, 'workloads')
    for name in os.listdir(wdir):
        path = os.path.join(wdir, name)
        with open(path) as f:
            t = json.load(f)
        with open(path, 'w') as f:
            json.dump(tiny_traffic(t), f)
    return root


def clock():
    t0 = time.perf_counter()
    return lambda: time.perf_counter() - t0
