"""The check that decides `correct` fails what it must: the control (the
plain reference in the program's place, in float8 where the
configuration states bf16) and each fault that a cell can have, planted
in the program underneath a run that skips the look for a card. On the
CPU at a small size; `calibrate.py` reads the same on the card at each
cell's own size."""
import pytest
import torch

from benchmark import faults
from benchmark.calibrate import control_numbers
from benchmark.harness.check import judge
from benchmark.harness.runner import cell_files, run_cell

from bench_util import bench, clock, tiny_root

SEED = 2 ** 31 + 29
CELLS = [w['name'] for w in bench()['workloads']]
KIND = {c: cell_files(bench(), c)[2]['kind'] for c in CELLS}


@pytest.mark.parametrize('cell', CELLS)
def test_control_is_not_correct(cell, tmp_path):
    root = tiny_root(tmp_path)
    _, cfg, traffic, limits = cell_files(bench(), cell, root)
    numbers = control_numbers(cfg, traffic, SEED, torch.device('cpu'))
    assert not judge(numbers, limits)[1], numbers


@pytest.mark.parametrize('cell,fault', [(c, f) for c in CELLS
                                        for f in faults.FAULTS[KIND[c]]])
def test_a_run_with_a_fault_underneath_is_not_correct(cell, fault,
                                                      tmp_path):
    root = tiny_root(tmp_path)
    with faults.plant(fault):
        res, lines = run_cell(bench(), cell, SEED, 1.5, 0, 'cpu', clock(),
                              root=root)
    assert res['correct'] is False, lines
    assert res['attempted'] > 0
