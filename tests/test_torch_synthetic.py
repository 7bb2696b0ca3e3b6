"""`random_padded_nag` (numpy only) vs the batch the JAX host path
makes: the same fields, dtypes and trailing widths, and the padding
invariants of `pad_nag`; and `from_numpy` gives both the same
inference batch layout."""
import dataclasses

import numpy as np
import pytest
import torch

from superpoint_transformer_tpu.data.pad import bucket as jax_bucket
from superpoint_transformer_tpu.transforms import BatchConfig, prepare_batch
from superpoint_transformer_tpu.utils.synthetic import random_nag
from superpoint_transformer_torch.data.pad import bucket
from superpoint_transformer_torch.data.padded import PaddedLevel, from_numpy
from superpoint_transformer_torch.utils.synthetic import random_padded_nag

# built only for the training backward (with_transpose=True)
_TRANSPOSE = {'nbr_in_idx', 'nbr_in_mask'}


@pytest.fixture(scope='module')
def host():
    nags = [random_nag(seed=0), random_nag(seed=1)]
    cfg = BatchConfig(sample_graph_r=-1, sample_segment_ratio=0)
    return prepare_batch(nags, cfg, train=False, device=False)


@pytest.fixture(scope='module')
def synth():
    return random_padded_nag(seed=0, num_graphs=3, n_points=700, n_l1=60,
                             n_l2=15)


def _fields(lvl):
    return {f.name: getattr(lvl, f.name)
            for f in dataclasses.fields(PaddedLevel)
            if getattr(lvl, f.name, None) is not None}


def test_same_fields_dtypes_and_widths(host, synth):
    assert len(host.levels) == len(synth.levels) == 3
    assert host.start_i_level == synth.start_i_level == 0
    for h, s in zip(host.levels, synth.levels):
        hf, sf = _fields(h), _fields(s)
        assert set(sf) == set(hf) - _TRANSPOSE
        for name, a in sf.items():
            b = hf[name]
            assert np.asarray(a).dtype == np.asarray(b).dtype, name
            # K (axis 1 of the neighbor tables) depends on the graph
            skip = 2 if name in ('nbr_idx', 'nbr_mask', 'edge_feat') else 1
            assert np.shape(a)[skip:] == np.shape(b)[skip:], name
    assert synth.levels[0].x.shape[1] == 8
    assert synth.levels[1].edge_feat.shape[2] == 18


def test_padding_invariants(synth):
    _check_invariants(synth)


def test_node_caps_pads_on(synth):
    """`node_caps` pads the same node counts on to the given
    capacities, with every padding invariant."""
    caps = {i: lvl.capacity + 256 for i, lvl in enumerate(synth.levels)}
    b = random_padded_nag(seed=0, num_graphs=3, n_points=700, n_l1=60,
                          n_l2=15, node_caps=caps)
    assert [lvl.capacity for lvl in b.levels] == list(caps.values())
    assert [int(lvl.num_nodes) for lvl in b.levels] == \
        [int(lvl.num_nodes) for lvl in synth.levels]
    _check_invariants(b)


def _check_invariants(synth):
    levels = synth.levels
    for i, lvl in enumerate(levels):
        n, cap = int(lvl.num_nodes), lvl.capacity
        assert cap % 128 == 0 and n <= cap
        assert lvl.node_mask[:n].all() and not lvl.node_mask[n:].any()
        assert np.all(lvl.batch[n:] == -1)
        b = lvl.batch[:n]
        assert b.min() == 0 and b.max() == synth.num_graphs - 1
        assert np.all(np.diff(b) >= 0)          # graphs contiguous
        if lvl.super_index is not None:
            parent = levels[i + 1]
            si = lvl.super_index
            assert np.all(si[n:] == parent.capacity)
            assert np.all(np.diff(si[:n]) >= 0)     # sorted by parent
            # every valid parent has a child, of the same graph
            assert set(si[:n]) == set(range(int(parent.num_nodes)))
            assert np.array_equal(parent.batch[si[:n]], b)
        for a in (lvl.pos, lvl.node_size, lvl.x, lvl.edge_feat):
            assert a is None or np.isfinite(a).all()
        if lvl.nbr_idx is not None:
            idx, m = lvl.nbr_idx, lvl.nbr_mask
            assert idx.shape[1] % 16 == 0 and idx.shape == m.shape
            assert np.array_equal(idx[:n, 0], np.arange(n))   # self-loop
            assert m[:n, 0].all() and not m[n:].any()
            assert np.all(idx[~m] == 0)
            assert np.all(lvl.batch[idx[:n]][m[:n]] ==
                          np.repeat(b, m[:n].sum(1)))
            assert np.all(lvl.edge_feat[np.arange(n), 0] == 0)
    nid = levels[1].node_id
    n1 = int(levels[1].num_nodes)
    assert np.array_equal(np.sort(nid[:n1]), np.arange(n1))
    assert np.all(nid[n1:] == -1)


def test_serving_size_shape():
    """The 'demo room x8' serving shape: ~330k points, ~10k level-1 and
    a few thousand level-2 nodes over 8 graphs, K between 32 and 64."""
    b = random_padded_nag(seed=0, num_graphs=8, n_points=41_500,
                          n_l1=1_250, n_l2=350)
    n0, n1, n2 = (int(l.num_nodes) for l in b.levels)
    assert 300_000 < n0 < 360_000
    assert 9_000 < n1 < 11_000
    assert 2_000 < n2 < 4_000
    for lvl in b.levels[1:]:
        assert 32 <= lvl.nbr_idx.shape[1] <= 64


@pytest.mark.parametrize('compute_dtype', [None, 'bfloat16'])
def test_from_numpy_same_layout_for_both(host, synth, compute_dtype):
    feat = torch.bfloat16 if compute_dtype else torch.float32
    a = from_numpy(host, 'cpu', compute_dtype)
    b = from_numpy(synth, 'cpu', compute_dtype)
    assert a.level1_node_id is not None and b.level1_node_id is not None
    for la, lb in zip(a.levels, b.levels):
        fa, fb = _fields(la), _fields(lb)
        assert set(fa) == set(fb)
        assert not {'y', 'node_id', 'nbr_in_idx', 'nbr_in_mask'} & set(fa)
        for name, t in fa.items():
            if name == 'num_nodes':
                assert isinstance(t, int)
                continue
            assert t.dtype == fb[name].dtype, name
            if name in ('x', 'edge_feat'):
                assert t.dtype == feat
            elif name in ('batch', 'super_index', 'nbr_idx'):
                assert t.dtype == torch.int64


def test_bucket_matches_host_path():
    for n in [0, 1, 127, 128, 129, 640, 1000, 9932, 10_113, 327_844,
              1 << 20]:
        assert bucket(n) == jax_bucket(n, 'pow2_fine'), n
        for mode in ('pow2', 'pow2_fine', 'exact'):
            assert bucket(n, mode) == jax_bucket(n, mode), (mode, n)
