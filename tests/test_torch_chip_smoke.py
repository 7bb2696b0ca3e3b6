"""The bound arithmetic of `chip_smoke.py`, without a card: the bytes and
FLOPs of one call of each kernel at the flagship shapes, and which of the
two bounds it. The script imports nothing but the standard library at
module level, so it imports here."""
import os
import sys

import pytest

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))
import chip_smoke  # noqa: E402

FLAGSHIP = dict(H=16, D=4, C=64)


@pytest.mark.parametrize('name, shape, mbytes, gflop', [
    # serving level 1: kvg 12 KB, ef 3 KB, q, mask, scale, f32 out a node
    ('K2', dict(N=10_240, K=48, De=32), 162, 6.26),
    # training level 1, per-edge q: q, k, v 6 KB each a node
    ('K1', dict(N=5_120, K=48), 96, 0.0786),
    # K2's inputs, out, lse and g in; dq, dkg, dvg, d_ef out
    ('K3', dict(N=5_120, K=48, De=32), 162, 9.23)],
    ids=['K2', 'K1', 'K3'])
def test_flagship_bytes_and_flops(name, shape, mbytes, gflop):
    nbytes, prod, other = chip_smoke.kernel_cost(name, **shape, **FLAGSHIP)
    assert nbytes / 1e6 == pytest.approx(mbytes, rel=1e-2)
    assert (prod + other) / 1e9 == pytest.approx(gflop, rel=1e-2)
    ms, by = chip_smoke.bound(name, **shape, **FLAGSHIP)
    assert by == 'bytes'
    assert ms == pytest.approx(nbytes / chip_smoke.PEAK_BYTES_S * 1e3)


def test_k1_query_per_node_reads_one_query_row_a_node():
    shape = dict(N=5_120, K=48, **FLAGSHIP)
    edge = chip_smoke.kernel_cost('K1', **shape)[0]
    node = chip_smoke.kernel_cost('K1', **shape, q_per_edge=False)[0]
    assert edge - node == 5_120 * (48 - 1) * 64 * 2


def test_bound_takes_operations_when_they_dominate(monkeypatch):
    """On a card whose memory were 100x faster, K2's projections on the
    tensor cores and its f32 work would bound it."""
    shape = dict(N=10_240, K=48, De=32, **FLAGSHIP)
    monkeypatch.setattr(chip_smoke, 'PEAK_BYTES_S', 335e12)
    nbytes, prod, other = chip_smoke.kernel_cost('K2', **shape)
    ms, by = chip_smoke.bound('K2', **shape)
    op_ms = (prod / chip_smoke.PEAK_BF16_FLOP_S
             + other / chip_smoke.PEAK_F32_FLOP_S) * 1e3
    assert by == 'operations' and ms == pytest.approx(op_ms)
    assert op_ms > nbytes / 335e12 * 1e3
