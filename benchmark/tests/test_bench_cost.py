"""The yardstick's arithmetic: the valid-slot cost of a kernel call is
the program's `kernel_cost` when every slot is valid, and the analytic
FLOP count is what `FlopCounterMode` counts over the reference."""
import json
import os

import numpy as np
import pytest
import torch
from torch.utils.flop_counter import FlopCounterMode

from benchmark.harness.cost import attention_launches, kernel_cost
from benchmark.harness.runner import BENCH_DIR
from benchmark.harness.traffic import batch_sizes, make_batch
from benchmark.harness.weights import draw_weights
from benchmark.reference import spt as ref
from superpoint_transformer_torch.ops.cost import kernel_cost as program_cost

SHAPES = [dict(N=5120, K=48, H=16, D=4, C=64, De=32),
          dict(N=896, K=32, H=16, D=4, C=64, De=32),
          dict(N=16384, K=64, H=8, D=4, C=32, De=16)]


@pytest.mark.parametrize('name', ['K1', 'K2'])
@pytest.mark.parametrize('shape', SHAPES)
def test_valid_slot_cost_is_the_programs_when_every_slot_is_valid(
        name, shape):
    s = dict(shape)
    N, K = s.pop('N'), s.pop('K')
    # K1 as the flagship calls it: a query a neighbor slot
    assert kernel_cost(name, N, N * K, **s) == \
        program_cost(name, N, K, q_per_edge=True, **s)
    # fewer valid slots cost less
    assert kernel_cost(name, N, N * K // 2, **s)[0] < kernel_cost(
        name, N, N * K, **s)[0]


@pytest.mark.parametrize('config', ['spt2_s3dis', 'spt3_dales'])
def test_flop_count_is_flop_counter_mode_over_the_reference(config):
    with open(os.path.join(BENCH_DIR, 'configs', config + '.json')) as f:
        m = json.load(f)['model']
    L = len(m['down_dim'])
    levels = [{'nodes': 600, 'spread': 0.2}] + [
        {'nodes': 60 // (i + 1), 'spread': 1.0, 'degree_mean': 12,
         'degree_max': 16} for i in range(L)]
    b = make_batch(5, 2, levels, m['point_hf_dim'], m['edge_hf_dim'],
                   m['num_classes'], [10, 8, 3])
    for lvl in b.levels[1:]:             # every slot valid
        lvl.nbr_mask[:int(lvl.num_nodes)] = True
    sizes = batch_sizes(b)
    assert all(e == n * 16 for n, e in sizes[1:])
    w = draw_weights(m, 1, 'cpu')
    with torch.no_grad(), FlopCounterMode(display=False) as fc:
        ref.forward(m, w, ref.levels_from_host(b, 'cpu'), 2)
    assert fc.get_total_flops() == ref.flops_forward(m, sizes)
    launches = attention_launches(m, sizes)
    assert len(launches) == L * m['down_num_blocks'] + len(
        m['up_dim']) * m['up_num_blocks']
    assert np.all([e > 0 and C == m['down_dim'][0] for _, e, C in launches])
