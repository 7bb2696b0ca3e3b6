"""The generator repeats itself from the seed, keeps the padding
invariants of `pad_nag`, and hits the level sizes and neighbor counts of
each traffic file."""
import json
import os

import numpy as np
import pytest

from benchmark.harness.common import make_pool
from benchmark.harness.runner import BENCH_DIR
from benchmark.harness.traffic import bucket, transpose_neighbors

from bench_util import bench

SEED = 2 ** 31 + 23
CELLS = [(w['config'], w['traffic']) for w in bench()['workloads']]


def _load(*parts):
    with open(os.path.join(BENCH_DIR, *parts)) as f:
        return json.load(f)


@pytest.mark.parametrize('config,traffic', CELLS)
def test_generator_hits_the_traffic_file(config, traffic):
    cfg, t = _load('configs', config + '.json'), _load('workloads',
                                                      traffic + '.json')
    train = t['kind'] == 'train'
    pool, sizes = make_pool(cfg, t, SEED, train=train)
    assert len(pool) == t['pool']
    G = t['graphs']
    for batch, size in zip(pool, sizes):
        assert batch.num_graphs == G and len(batch.levels) == len(
            t['levels'])
        for l, (lvl, spec) in enumerate(zip(batch.levels, t['levels'])):
            n = int(lvl.num_nodes)
            assert lvl.pos.shape[0] == bucket(n)
            # +-10% a graph, floored by the level above
            assert 0.9 * G * spec['nodes'] - G <= n <= 1.1 * G * spec[
                'nodes'] + 1
            assert (lvl.batch[:n] >= 0).all() and (lvl.batch[n:] == -1).all()
            assert np.all(np.diff(lvl.batch[:n]) >= 0)
            if l + 1 < len(batch.levels):
                up = batch.levels[l + 1]
                si = lvl.super_index
                assert np.all(np.diff(si[:n]) >= 0)
                assert (si[n:] == up.pos.shape[0]).all()
                assert len(np.unique(si[:n])) == int(up.num_nodes)
                assert (up.batch[si[:n]] == lvl.batch[:n]).all()
            if l == 0:
                assert lvl.x.shape[1] == cfg['model']['point_hf_dim']
                continue
            deg = lvl.nbr_mask[:n].sum(1)
            assert deg.max() == spec['degree_max']
            assert abs(deg.mean() - spec['degree_mean']) \
                < 0.03 * spec['degree_mean']
            assert lvl.nbr_idx.shape[1] % 16 == 0
            assert (lvl.nbr_idx[:n, 0] == np.arange(n)).all()
            assert not lvl.nbr_mask[n:].any()
            assert (lvl.edge_feat[:n, 0] == 0).all()
            assert lvl.edge_feat.shape[2] == cfg['model']['edge_hf_dim']
            assert size[l] == (n, int(deg.sum()))
            if train:
                ii, im = transpose_neighbors(lvl.nbr_idx, lvl.nbr_mask)
                np.testing.assert_array_equal(lvl.nbr_in_idx, ii)
                assert im.sum() == deg.sum()
        nid = batch.levels[1].node_id
        n1 = int(batch.levels[1].num_nodes)
        np.testing.assert_array_equal(np.sort(nid[:n1]), np.arange(n1))
        assert (batch.levels[0].y is not None) == train


def test_generator_repeats_itself_from_the_seed():
    cfg = _load('configs', 'spt3_dales.json')
    t = _load('workloads', 'dales_serve_1tile.json')
    t['pool'] = 2
    for lvl in t['levels']:
        lvl['nodes'] //= 400
    a, _ = make_pool(cfg, t, SEED, train=True)
    b, _ = make_pool(cfg, t, SEED, train=True)
    c, _ = make_pool(cfg, t, SEED + 1, train=True)
    for x, y, z in zip(a, b, c):
        for lx, ly, lz in zip(x.levels, y.levels, z.levels):
            for k, v in vars(lx).items():
                if isinstance(v, np.ndarray):
                    np.testing.assert_array_equal(v, getattr(ly, k))
            assert not np.array_equal(lx.pos, lz.pos)
    assert not np.array_equal(a[0].levels[0].pos, a[1].levels[0].pos)
