"""`random_padded_nag` (numpy only) vs the batch the JAX host path
makes: the same fields (the transpose neighbor tables included), dtypes
and trailing widths, and the padding invariants of `pad_nag`; and
`from_numpy` gives both the same inference and training batch
layouts."""
import dataclasses

import numpy as np
import pytest
import torch

from superpoint_transformer_tpu.data.pad import bucket as jax_bucket
from superpoint_transformer_tpu.transforms import BatchConfig, prepare_batch
from superpoint_transformer_tpu.utils.synthetic import random_nag
from superpoint_transformer_torch.data.pad import bucket
from superpoint_transformer_torch.data import padded
from superpoint_transformer_torch.data.padded import (PaddedLevel, PaddedNAG,
                                                      from_numpy,
                                                      strip_for_inference)
from superpoint_transformer_torch.inference import stack_batches
from superpoint_transformer_torch.utils.synthetic import random_padded_nag

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
        assert set(sf) == set(hf)
        for name, a in sf.items():
            b = hf[name]
            assert np.asarray(a).dtype == np.asarray(b).dtype, name
            # K and K_in (axis 1 of the neighbor tables) depend on the
            # graph
            skip = 2 if name in ('nbr_idx', 'nbr_mask', 'edge_feat',
                                 'nbr_in_idx', 'nbr_in_mask') else 1
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
            # the transpose table lists each valid slot once, under the
            # node it points at
            ii, im = lvl.nbr_in_idx, lvl.nbr_in_mask
            assert ii.shape[0] == cap and ii.shape[1] % 16 == 0
            assert np.all(ii[~im] == 0)
            assert np.array_equal(np.sort(ii[im]),
                                  np.flatnonzero(m.reshape(-1)))
            assert np.all(idx.reshape(-1)[ii[im]] ==
                          np.nonzero(im)[0])
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
    _same_layout(host, synth, compute_dtype, train=False)


@pytest.mark.parametrize('compute_dtype', [None, 'bfloat16'])
def test_from_numpy_same_training_layout_for_both(host, synth,
                                                  compute_dtype):
    _same_layout(host, synth, compute_dtype, train=True)


def _same_layout(host, synth, compute_dtype, train):
    feat = torch.bfloat16 if compute_dtype else torch.float32
    a = from_numpy(host, 'cpu', compute_dtype, train=train)
    b = from_numpy(synth, 'cpu', compute_dtype, train=train)
    assert a.level1_node_id is not None and b.level1_node_id is not None
    for i, (la, lb) in enumerate(zip(a.levels, b.levels)):
        fa, fb = _fields(la), _fields(lb)
        assert set(fa) == set(fb)
        assert 'node_id' not in fa
        train_only = {'y'} | ({'nbr_in_idx', 'nbr_in_mask'} if i else set())
        assert train_only <= set(fa) if train else \
            not train_only & set(fa)
        for name, t in fa.items():
            if name == 'num_nodes':
                assert isinstance(t, int)
                continue
            assert t.dtype == fb[name].dtype, name
            if name in ('x', 'edge_feat'):
                assert t.dtype == feat
            elif name in ('batch', 'super_index', 'nbr_idx'):
                assert t.dtype == torch.int64


def _int64_leaves(batch):
    """`batch` with every integer leaf widened to int64 on the host."""
    return PaddedNAG(
        levels=tuple(dataclasses.replace(lvl, **{
            name: np.asarray(a).astype(np.int64)
            for name, a in _fields(lvl).items()
            if np.issubdtype(np.asarray(a).dtype, np.integer)})
            for lvl in batch.levels),
        start_i_level=batch.start_i_level, num_graphs=batch.num_graphs)


def _bits(t):
    return t.contiguous().reshape(-1).view(torch.uint8)


@pytest.mark.parametrize('compute_dtype', [None, 'bfloat16'])
@pytest.mark.parametrize('case', ['serve', 'train', 'stacked', 'host_path',
                                  'int64'])
def test_staged_batch_equals_the_per_leaf_batch(host, synth, case,
                                                compute_dtype):
    """The staged path (one buffer, integers across as int32 and widened
    after the copy), with the CPU standing in for the card and an
    unpinned ring, gives every leaf the per-leaf path's dtype, shape and
    bits."""
    batch, train = {
        'serve': (synth, False), 'train': (synth, True),
        'stacked': (stack_batches([strip_for_inference(synth)] * 2), False),
        'host_path': (host, True), 'int64': (_int64_leaves(synth), True),
    }[case]
    want = from_numpy(batch, 'cpu', compute_dtype, train=train)
    got = padded._from_numpy(batch, torch.device('cpu'), compute_dtype,
                             train, padded._StagingRing(pin=False))
    assert got.start_i_level == want.start_i_level
    assert got.num_graphs == want.num_graphs
    assert np.array_equal(got.level1_node_id, want.level1_node_id)
    for lg, lw in zip(got.levels, want.levels):
        fg, fw = _fields(lg), _fields(lw)
        assert set(fg) == set(fw)
        for name, w in fw.items():
            g = fg[name]
            if not isinstance(w, torch.Tensor):
                assert g == w, name
                continue
            assert (g.dtype, g.shape) == (w.dtype, w.shape), name
            assert torch.equal(_bits(g), _bits(w)), name


def test_staged_batch_saves_and_loads(synth, tmp_path):
    """`torch.save` refuses views of one buffer in several dtypes; a
    staged batch's levels pickle each leaf on its own (the Trainer hands
    its batches to the ranks so)."""
    got = padded._from_numpy(synth, torch.device('cpu'), 'bfloat16', True,
                             padded._StagingRing(pin=False))
    torch.save(got, tmp_path / 'batch.pt')
    back = torch.load(tmp_path / 'batch.pt', weights_only=False)
    for lg, lb in zip(got.levels, back.levels):
        for name, t in _fields(lg).items():
            b = getattr(lb, name)
            assert torch.equal(t, b) if isinstance(t, torch.Tensor) \
                else t == b, name


def _leaves(nbytes):
    """One f32 leaf of `nbytes` bytes, as `_plan` takes it."""
    return [((0, 'pos'), 'pos', np.ones(nbytes // 4, np.float32))]


def test_staging_ring_alternates_and_grows_to_the_largest_batch():
    ring = padded._StagingRing(pin=False)
    small, large = (padded._plan(_leaves(n), None) for n in (3000, 40_000))
    grows, sizes = padded.from_numpy.stage_grows, []
    for plan, used in (small, large, large, small, small, large):
        out = ring.stage(plan, used, torch.device('cpu'))
        assert torch.equal(out.view(torch.float32), torch.ones(used // 4))
        sizes.append([s.numel() for s in ring.slots if s is not None])
    # slot 0 takes the 1st, 3rd and 5th batch, slot 1 the others; a slot
    # grows to a power of two above the largest it held, once
    assert sizes == [[4096], [4096, 65536], [65536, 65536],
                     [65536, 65536], [65536, 65536], [65536, 65536]]
    assert padded.from_numpy.stage_grows - grows == 3
    assert ring.next == 0


def test_staging_refuses_indices_past_int32_before_any_write():
    big = np.broadcast_to(np.float32(0), (2 ** 31, 3))  # no memory
    lvl = PaddedLevel(pos=big, node_mask=np.broadcast_to(True, (2 ** 31,)),
                      batch=np.broadcast_to(np.int32(0), (2 ** 31,)),
                      num_nodes=1)
    ring = padded._StagingRing(pin=False)
    grows = padded.from_numpy.stage_grows
    with pytest.raises(ValueError, match='int32'):
        padded._from_numpy(PaddedNAG(levels=(lvl,)), torch.device('cpu'),
                           None, False, ring)
    assert ring.slots == [None, None] and ring.next == 0
    assert padded.from_numpy.stage_grows == grows


def test_bucket_matches_host_path():
    for n in [0, 1, 127, 128, 129, 640, 1000, 9932, 10_113, 327_844,
              1 << 20]:
        assert bucket(n) == jax_bucket(n, 'pow2_fine'), n
        for mode in ('pow2', 'pow2_fine', 'exact'):
            assert bucket(n, mode) == jax_bucket(n, mode), (mode, n)
