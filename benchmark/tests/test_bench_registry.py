"""The harness finds each configuration, traffic, limit file and metric
by its name: a cell and a metric added as new files and entries run with
no edit of any file the benchmark has."""
import json
import os

import pytest

from benchmark.harness.runner import metrics_of, run_cell

from bench_util import bench, clock, tiny_root

SEED = 2 ** 31 + 17


def test_new_config_traffic_cell_and_metric_run_without_an_edit(tmp_path):
    root = tiny_root(tmp_path)
    b = bench()
    with open(os.path.join(root, 'configs', 'spt2_s3dis.json')) as f:
        cfg = json.load(f)
    cfg['name'] = 'spt2_copy'
    with open(os.path.join(root, 'configs', 'spt2_copy.json'), 'w') as f:
        json.dump(cfg, f)
    with open(os.path.join(root, 'workloads',
                           's3dis_serve_8rooms.json')) as f:
        traffic = json.load(f)
    traffic['pool'] = 2
    with open(os.path.join(root, 'workloads', 'copy_serve.json'), 'w') as f:
        json.dump(traffic, f)
    with open(os.path.join(root, 'limits', 'spt2_copy.serve.json'),
              'w') as f:
        json.dump({'pred_gap_max': 1e9, 'pred_gap_mean': 1e9}, f)
    with open(os.path.join(root, 'metrics', 'answers_seen.py'), 'w') as f:
        f.write('def read(run):\n    return run["attempted"]\n')
    b['configs'].append({'name': 'spt2_copy', 'source': 'test',
                         'file': 'benchmark/configs/spt2_copy.json',
                         'reduced': [], 'why': 'test'})
    b['workloads'].append({'name': 'spt2_copy.serve', 'config': 'spt2_copy',
                           'traffic': 'copy_serve', 'chips': 1,
                           'why': 'test'})
    for m in b['end_to_end']:
        if 'serve_points_per_s' == m['name']:
            m['workloads'].append('spt2_copy.serve')
    b['per_layer'].append({'name': 'answers_seen', 'unit': 'req',
                           'better': 'higher', 'source': 'host_clock',
                           'layer': 'test', 'moves': 'serve_points_per_s'})
    res, lines = run_cell(b, 'spt2_copy.serve', SEED, 0.5, 1, 'cpu', clock(),
                          root=root)
    assert res['correct'], lines
    assert res['metrics']['answers_seen']['value'] == res['attempted'] > 0
    assert list(res)[-1] == 'checks'
    res, _ = run_cell(b, 'spt2_copy.serve', SEED, 0.5, 0, 'cpu', clock(),
                      root=root)
    assert set(res['metrics']) == {'serve_points_per_s', 'setup_s'}


@pytest.mark.parametrize('cell', [w['name'] for w in bench()['workloads']])
def test_every_cell_reports_setup_an_end_to_end_and_a_per_layer_metric(
        cell):
    b = bench()
    e2e = {m['name'] for m in metrics_of(b, cell, False)}
    layer = metrics_of(b, cell, True)
    assert 'setup_s' in e2e and len(e2e) >= 2
    assert layer and all(m['moves'] in e2e for m in layer)
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    for m in list(b['end_to_end']) + list(b['per_layer']):
        assert os.path.exists(os.path.join(root, 'metrics',
                                           m['name'] + '.py')), m['name']
