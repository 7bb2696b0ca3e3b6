"""Before the benchmark's tests are collected: the panoptic serving kind
brings its own faults and control (`panoptic_faults.register`), so that
the tests of every declared cell's control and faults take its cell.

The tests run the panoptic program in f32: its limits are set on the
card, and bf16 on the CPU rounds otherwise (a sound run of the tiny cell
there reads an affinity gap twice its limit), so a fault's run would
fail for its precision alone."""
import copy

import pytest

from benchmark.panoptic_faults import register

register()


@pytest.fixture(scope='session', autouse=True)
def panoptic_program_in_f32():
    from superpoint_transformer_torch import experiment
    cfg = copy.deepcopy(experiment.PANOPTIC_DALES_CFG)
    cfg['trainer']['precision'] = '32'
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(experiment, 'PANOPTIC_DALES_CFG', cfg)
        yield
