"""Device preprocessing in the port (`ops/device_preprocess.py`:
`voxelize_device`, `grid_knn_device`; `knn_search(backend='device')`,
`preprocess_cloud(knn_backend='device')`) against the JAX package's jitted
versions, on the CPU, from the same numpy inputs.

Integer results (voxel ids, counts, neighbor ids) must be equal. Means
and distances are held to 1e-6 relative: both sides sum and square in
f32, but XLA:CPU computes a few squared distances with fused
multiply-adds (the tail lanes of its parallel partitions), an ulp off the
separately rounded products the port takes. So on a random cloud two
candidates an ulp apart may come out swapped: a neighbor id that differs
must sit at a distance within 1e-6 of the JAX one it displaces, in at
most 1e-3 of the slots. The neighbor order on equal distances is JAX's
(`lax.top_k`: the lower candidate column first), exactly, on a lattice
cloud with exact coordinates where most distances tie. The results do
not depend on the port's query blocks and candidate pieces.
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from superpoint_transformer_tpu.data.data import Data as JData
from superpoint_transformer_tpu.ops import device_preprocess as jdp
from superpoint_transformer_tpu.transforms import preprocess as jpre
from superpoint_transformer_tpu.utils import synthetic as jsyn
from superpoint_transformer_torch.data.data import Data as TData
from superpoint_transformer_torch.ops import device_preprocess as tdp
from superpoint_transformer_torch.transforms import preprocess as tpre
from superpoint_transformer_torch.utils import synthetic as tsyn
from test_torch_host_path import PRE, PRE_RTOL, ROOM_POINTS, assert_nags_equal
from test_torch_trainer import one_torch_thread  # noqa: F401

RTOL = 1e-6


def _cloud(n, seed, masked=0):
    rng = np.random.default_rng(seed)
    pos = rng.uniform(-1, 2, (n, 3)).astype(np.float32)
    feats = rng.normal(size=(n, 4)).astype(np.float32)
    valid = np.ones(n, bool)
    if masked:
        valid[rng.choice(n, masked, replace=False)] = False
    return pos, feats, valid


def _lattice(side=10, step=0.25, seed=0):
    """A shuffled cubic lattice with exact coordinates: most neighbor
    distances tie exactly."""
    g = np.arange(side, dtype=np.float32) * np.float32(step)
    pos = np.stack(np.meshgrid(g, g, g, indexing='ij'), -1).reshape(-1, 3)
    return pos[np.random.default_rng(seed).permutation(len(pos))]


def _assert_neighbors(nbr, dist, jnbr, jdist):
    """Distances within RTOL; ids equal, but for swaps of candidates at
    distances within RTOL (see the module docstring)."""
    nbr, dist = np.asarray(nbr), np.asarray(dist)
    jnbr, jdist = np.asarray(jnbr), np.asarray(jdist)
    _assert_dist(dist, jdist)
    diff = np.argwhere(nbr != jnbr)
    assert len(diff) <= 1e-3 * nbr.size, len(diff)
    for i, s in diff:
        at = np.where(jnbr[i] == nbr[i, s])[0]
        # the JAX slot of the same id, or its k-th slot (a swap across
        # the boundary of the k kept)
        s2 = at[0] if len(at) else nbr.shape[1] - 1
        np.testing.assert_allclose(jdist[i, s2], jdist[i, s], rtol=RTOL,
                                   err_msg=f'row {i} slot {s}')


def _assert_dist(got, ref):
    got, ref = np.asarray(got), np.asarray(ref)
    np.testing.assert_array_equal(np.isfinite(got), np.isfinite(ref))
    fin = np.isfinite(ref)
    np.testing.assert_allclose(got[fin], ref[fin], rtol=RTOL, atol=0)


@pytest.mark.parametrize('size, masked, feat_dim', [
    (0.3, 0, 4), (0.3, 300, 4), (0.07, 0, 4), (0.3, 0, 0)],
    ids=['coarse', 'masked', 'fine', 'no_features'])
def test_voxelize_device_matches_jax(size, masked, feat_dim):
    pos, feats, valid = _cloud(2_000, seed=0, masked=masked)
    feats = feats[:, :feat_dim]
    cap = 4_096
    ref = jdp.voxelize_device(jnp.asarray(pos), jnp.asarray(feats),
                              jnp.asarray(valid), size, voxel_cap=cap)
    got = tdp.voxelize_device(torch.from_numpy(pos), torch.from_numpy(feats),
                              torch.from_numpy(valid), size, voxel_cap=cap)
    for k in ('super_index', 'counts'):
        assert got[k].dtype == torch.int32
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(ref[k]))
    assert int(got['num_voxels']) == int(ref['num_voxels']) > 0
    assert (got['super_index'].numpy()[~valid] == -1).all()
    for k in ('pos_mean', 'feat_mean'):
        assert tuple(got[k].shape) == np.asarray(ref[k]).shape
        np.testing.assert_allclose(got[k].numpy(), np.asarray(ref[k]),
                                   rtol=RTOL, atol=0)


def _knn_both(pos, valid, **kw):
    ref = jdp.grid_knn_device(jnp.asarray(pos), jnp.asarray(valid), **kw)
    got = tdp.grid_knn_device(torch.from_numpy(pos), torch.from_numpy(valid),
                              **kw)
    return got, ref


@pytest.mark.parametrize('seed, masked, kw', [
    (1, 0, dict(r=0.4, k=8, cell_cap=64, chunk=128)),
    (2, 400, dict(r=0.4, k=8, cell_cap=64, chunk=128)),
    (3, 0, dict(r=0.5, k=12, cell_cap=8, chunk=256, cell_size=0.125,
                reach=3)),
], ids=['random', 'masked', 'reach3_truncating'])
def test_grid_knn_device_matches_jax(seed, masked, kw):
    pos, _, valid = _cloud(2_000, seed=seed, masked=masked)
    (nbr, dist), (jnbr, jdist) = _knn_both(pos, valid, **kw)
    assert nbr.dtype == torch.int32 and dist.dtype == torch.float32
    _assert_neighbors(nbr, dist, jnbr, jdist)
    if masked:
        assert (nbr.numpy()[~valid] == -1).all()
        assert not np.isin(nbr.numpy(), np.where(~valid)[0]).any()


@pytest.mark.parametrize('kw', [
    dict(r=0.6, k=12, cell_cap=8, chunk=256),
    dict(r=0.6, k=20, cell_cap=4, chunk=100, cell_size=0.25, reach=2)],
    ids=['reach1', 'reach2'])
def test_grid_knn_device_tie_order_is_jax_s(kw):
    pos = _lattice()
    valid = np.ones(len(pos), bool)
    (nbr, dist), (jnbr, jdist) = _knn_both(pos, valid, **kw)
    d = np.asarray(jdist)
    fin = np.isfinite(d[:, 1:]) & np.isfinite(d[:, :-1])
    # most neighbors tie with the next one: the order is all tie-breaking
    assert (d[:, 1:] == d[:, :-1])[fin].mean() > 0.5
    np.testing.assert_array_equal(nbr.numpy(), np.asarray(jnbr))
    np.testing.assert_array_equal(dist.numpy(), d)


@pytest.mark.parametrize('cloud', ['random', 'lattice'])
def test_grid_knn_device_does_not_depend_on_the_chunks(cloud, monkeypatch):
    if cloud == 'lattice':
        pos = _lattice()
        valid = np.ones(len(pos), bool)
    else:
        pos, _, valid = _cloud(1_500, seed=4, masked=100)
    kw = dict(r=0.6, k=10, cell_cap=16, cell_size=0.25, reach=2)
    pos_t, valid_t = torch.from_numpy(pos), torch.from_numpy(valid)
    base = tdp.grid_knn_device(pos_t, valid_t, chunk=4_096, **kw)
    for chunk, max_candidates in ((97, 1 << 22), (512, 3_000), (64, 1)):
        monkeypatch.setattr(tdp, '_MAX_CANDIDATES', max_candidates)
        got = tdp.grid_knn_device(pos_t, valid_t, chunk=chunk, **kw)
        assert torch.equal(got[0], base[0]) and torch.equal(got[1], base[1])


def test_grid_knn_device_pieces_bound_their_dense_tables(monkeypatch):
    """Each piece of query rows keeps rows x (its largest row candidate
    count, at least k) within `_MAX_CANDIDATES`, also where one dense
    cluster beside sparse points gives a few rows many candidates; the
    result is the one of unbounded pieces."""
    rng = np.random.default_rng(6)
    pos = np.concatenate([rng.normal(0, 0.02, (600, 3)),
                          rng.uniform(-2, 2, (900, 3))]).astype(np.float32)
    pos = pos[rng.permutation(len(pos))]
    valid = np.ones(len(pos), bool)
    kw = dict(r=0.6, k=10, cell_cap=256, cell_size=0.25, reach=2,
              chunk=4_096)
    pos_t, valid_t = torch.from_numpy(pos), torch.from_numpy(valid)
    base = tdp.grid_knn_device(pos_t, valid_t, **kw)
    budget = 20_000
    monkeypatch.setattr(tdp, '_MAX_CANDIDATES', budget)
    pieces, knn_piece = [], tdp._knn_piece

    def recording(q0, start, cnt, total, *args):
        pieces.append(cnt.sum(1).numpy())
        return knn_piece(q0, start, cnt, total, *args)

    monkeypatch.setattr(tdp, '_knn_piece', recording)
    got = tdp.grid_knn_device(pos_t, valid_t, **kw)
    assert torch.equal(got[0], base[0]) and torch.equal(got[1], base[1])
    row_cnt = np.concatenate(pieces)
    assert len(row_cnt) == len(pos)
    for piece in pieces:
        assert len(piece) == 1 or \
            len(piece) * max(piece.max(), kw['k']) <= budget
    # pieces cut by their candidate sum alone would break the bound
    cum, a, broken = np.cumsum(row_cnt), 0, False
    while a < len(row_cnt):
        b = max(int(np.searchsorted(cum, (cum[a - 1] if a else 0) + budget,
                                    side='right')), a + 1)
        broken |= (b - a) * row_cnt[a:b].max() > budget
        a = b
    assert broken


def test_piece_rows_takes_the_most_rows_within_the_budget(monkeypatch):
    monkeypatch.setattr(tdp, '_MAX_CANDIDATES', 100)
    assert tdp._piece_rows(np.array([5, 5, 5, 30, 1, 1]), 10) == 3
    assert tdp._piece_rows(np.array([1, 1, 1, 1]), 10) == 4
    assert tdp._piece_rows(np.array([500, 1]), 10) == 1
    assert tdp._piece_rows(np.array([0, 0, 0]), 50) == 2


@pytest.fixture(scope='module')
def clustered():
    """The JAX test's density-skewed scene: 6 tight clusters and a sparse
    background (tests/test_device_preprocess.py), KNN'd by the device
    backend of each package and the port's host backend."""
    rng = np.random.default_rng(0)
    centers = rng.random((6, 3)).astype(np.float32) * 8
    dense = (centers[rng.integers(0, 6, 4000)]
             + rng.normal(0, 0.05, (4000, 3)).astype(np.float32))
    sparse = rng.random((800, 3)).astype(np.float32) * 8
    pos = np.concatenate([dense, sparse]).astype(np.float32)
    kw = dict(k=10, r_max=1.0)
    ref = jpre.knn_search(JData(pos=pos.copy()), backend='device', **kw)
    got = tpre.knn_search(TData(pos=pos.copy()), backend='device',
                          device='cpu', **kw)
    host = tpre.knn_search(TData(pos=pos.copy()), **kw)
    return got, ref, host


def test_knn_search_device_matches_jax_on_a_clustered_scene(clustered):
    got, ref, _ = clustered
    assert got.neighbor_index.dtype == np.int64
    _assert_neighbors(got.neighbor_index, got.neighbor_distance,
                      ref.neighbor_index, ref.neighbor_distance)


def test_knn_search_device_recall_against_host(clustered):
    """The device backend finds >= 99% of the native host KNN's
    neighbors (the JAX test's bound), with the densest cell's cap."""
    got, _, host = clustered
    hn, dn = host.neighbor_index, got.neighbor_index
    hits = total = 0
    for h, d in zip(hn, dn):
        hs = set(h[h >= 0].tolist())
        hits += len(hs & set(d[d >= 0].tolist()))
        total += len(hs)
    assert hits / total >= 0.99, hits / total


def test_knn_search_device_needs_a_card_unless_asked_for_the_cpu(
        monkeypatch):
    monkeypatch.setattr(torch.cuda, 'is_available', lambda: False)
    pos = _cloud(100, seed=5)[0]
    with pytest.raises(RuntimeError, match='no CUDA device'):
        tpre.knn_search(TData(pos=pos), k=4, backend='device')
    with pytest.raises(ValueError, match='backend'):
        tpre.knn_search(TData(pos=pos), k=4, backend='gpu')


def test_preprocess_cloud_device_knn_matches_jax():
    raw_j = jsyn.synthetic_room_cloud(seed=0, n_points=ROOM_POINTS)
    raw_t = tsyn.synthetic_room_cloud(seed=0, n_points=ROOM_POINTS)
    ref = jpre.preprocess_cloud(raw_j, knn_backend='device', **PRE)
    got = tpre.preprocess_cloud(raw_t, knn_backend='device', device='cpu',
                                **PRE)
    assert got.num_levels == ref.num_levels == 4
    assert_nags_equal(got, ref, PRE_RTOL)


@pytest.mark.parametrize('pre, device, card', [
    (dict(knn_backend='device'), None, True),
    (dict(knn_backend='device'), 'cpu', False),
    (dict(), None, False)], ids=['device_knn_card', 'device_knn_cpu', 'host'])
def test_dataset_workers_see_the_card_where_preprocessing_runs_there(
        tmp_path, monkeypatch, pre, device, card):
    """`BaseDataset.process` keeps its worker pool with the device KNN,
    and its workers see the card when the KNN runs there."""
    from superpoint_transformer_torch.datasets import base, s3dis
    (tmp_path / 'raw').mkdir()
    ds = s3dis.S3DIS(str(tmp_path), fold=5, stage='train',
                     pre_transform_config=pre, num_workers=3, device=device)
    calls = []
    monkeypatch.setattr(base, 'map_in_workers',
                        lambda fn, items, n, card=False:
                        calls.append((list(items), n, card)))
    ds.process()
    assert calls == [(ds.cloud_ids, 3, card)]


def test_map_in_workers_hides_the_card_unless_asked(monkeypatch):
    """Spawned workers: CUDA_VISIBLE_DEVICES is emptied in each, unless
    `card`."""
    import os
    from superpoint_transformer_torch.datasets import base
    monkeypatch.setenv('CUDA_VISIBLE_DEVICES', '0')
    names = ['CUDA_VISIBLE_DEVICES'] * 2
    assert base.map_in_workers(os.getenv, names, 2) == ['', '']
    assert base.map_in_workers(os.getenv, names, 2, card=True) == ['0', '0']
