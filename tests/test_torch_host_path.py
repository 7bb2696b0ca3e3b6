"""The port's host NAG path against the JAX package on the CPU: the same
seeds through `batch_nags` / `sort_nag_by_super` / `pad_nag`,
`prepare_batch` (eval and train), `batch_signature`, `discover_caps`,
`preprocess_cloud`, the NAG file format, and a narrow f32 SPT through
`infer_nag` and `e2e_inference`.

Integer and bool fields must be equal. Float fields are held to 1e-6
relative in the batch path and 1e-5 in preprocessing; both sides run the
same numpy code and the same native sources, so bit-equal is expected.
The JAX side reaches `native/libspt_native.so`, the port its own build of
`native/*.cpp`.
"""
import dataclasses

import numpy as np
import pytest
import torch

import jax

from superpoint_transformer_tpu import inference as jinf
from superpoint_transformer_tpu.data import pad as jpad
from superpoint_transformer_tpu.models.semantic import (
    SemanticSegmentationModel as JModel)
from superpoint_transformer_tpu.models.spt import SPT as JSPT
from superpoint_transformer_tpu.ops import geometry as jgeo
from superpoint_transformer_tpu.transforms import prepare as jprep
from superpoint_transformer_tpu.transforms import preprocess as jpre
from superpoint_transformer_tpu.utils import synthetic as jsyn
from superpoint_transformer_torch import inference as tinf
from superpoint_transformer_torch.data import pad as tpad
from superpoint_transformer_torch.data.csr import CSRData
from superpoint_transformer_torch.data.nag import NAG as TNAG
from superpoint_transformer_torch.models.semantic import (
    SemanticSegmentationModel as TModel)
from superpoint_transformer_torch.models.spt import SPT as TSPT
from superpoint_transformer_torch.ops import geometry as tgeo
from superpoint_transformer_torch.transforms import prepare as tprep
from superpoint_transformer_torch.transforms import preprocess as tpre
from superpoint_transformer_torch.utils import synthetic as tsyn
from superpoint_transformer_torch.utils.jax_params import load_jax_params
from test_torch_spt import NARROW, TOL_F32, _params

BATCH_RTOL = 1e-6
PRE_RTOL = 1e-5
# the fast preprocessing settings of tests/test_inference.py
PRE = dict(voxel=0.1, knn=25, knn_r=10.0, knn_min_search=10,
           pcp_regularization=(0.1, 0.2, 0.3),
           pcp_spatial_weight=(0.1, 0.01, 0.001),
           pcp_cutoff=(10, 30, 100), graph_gap=(5.0, 30.0, 30.0))
ROOM_POINTS = 20_000


def assert_arrays_equal(name, got, ref, rtol):
    """Integer and bool arrays equal, float arrays within `rtol`
    relative; same dtype kind and shape either way."""
    got, ref = np.asarray(got), np.asarray(ref)
    assert got.shape == ref.shape, (name, got.shape, ref.shape)
    assert got.dtype.kind == ref.dtype.kind, (name, got.dtype, ref.dtype)
    if ref.dtype.kind == 'f':
        np.testing.assert_allclose(got, ref, rtol=rtol, atol=0,
                                   err_msg=name)
    else:
        np.testing.assert_array_equal(got, ref, err_msg=name)


def assert_nags_equal(got, ref, rtol):
    """Every key of every level, CSR pointers and values included."""
    assert got.start_i_level == ref.start_i_level
    assert got.levels == ref.levels
    for i in ref.levels:
        g, r = got[i], ref[i]
        assert sorted(g.keys()) == sorted(r.keys()), i
        for k in r.keys():
            name = f'level {i} {k}'
            if isinstance(g[k], CSRData):
                assert_arrays_equal(name + ' pointers', g[k].pointers,
                                    r[k].pointers, rtol)
                assert len(g[k].values) == len(r[k].values), name
                for j, (a, b) in enumerate(zip(g[k].values, r[k].values)):
                    assert_arrays_equal(f'{name} values[{j}]', a, b, rtol)
            else:
                assert_arrays_equal(name, g[k], r[k], rtol)


def assert_padded_equal(got, ref, rtol=BATCH_RTOL):
    """Field by field over every level of two padded batches with numpy
    leaves, `node_id` and the transpose tables included."""
    assert got.start_i_level == ref.start_i_level
    assert got.num_graphs == ref.num_graphs
    assert len(got.levels) == len(ref.levels)
    for i, (g, r) in enumerate(zip(got.levels, ref.levels)):
        for f in dataclasses.fields(r):
            a, b = getattr(g, f.name), getattr(r, f.name)
            assert (a is None) == (b is None), (i, f.name)
            if b is not None:
                assert_arrays_equal(f'level {i} {f.name}', a, b, rtol)


@pytest.fixture(scope='module')
def rooms():
    """The same small synthetic room preprocessed by each package:
    (JAX NAG, port NAG, port raw cloud)."""
    raw_j = jsyn.synthetic_room_cloud(seed=0, n_points=ROOM_POINTS)
    raw_t = tsyn.synthetic_room_cloud(seed=0, n_points=ROOM_POINTS)
    for k in raw_j.keys():
        np.testing.assert_array_equal(raw_t[k], raw_j[k])
    return (jpre.preprocess_cloud(raw_j.clone(), **PRE),
            tpre.preprocess_cloud(raw_t.clone(), **PRE), raw_t)


def test_random_nag_matches_jax():
    assert_nags_equal(tsyn.random_nag(seed=3), jsyn.random_nag(seed=3), 0)


@pytest.mark.parametrize('seed', [0, 1])
def test_batch_sort_pad_match_jax(seed):
    def run(pad, synth, **kw):
        big = pad.batch_nags([synth.random_nag(seed=seed),
                              synth.random_nag(seed=seed + 1)])
        return pad.pad_nag(big, num_classes=13, **kw), big

    ref, ref_big = run(jpad, jsyn, device=False)
    got, got_big = run(tpad, tsyn)
    # the batched NAG after the sort that pad_nag runs, and the batch
    assert_nags_equal(got_big, ref_big, 0)
    assert_padded_equal(got, ref)
    assert got.levels[1].node_id is not None


def _nags(rooms, source, mod):
    if source == 'random':
        synth = jsyn if mod is jprep else tsyn
        return [synth.random_nag(seed=0), synth.random_nag(seed=1)]
    nag = rooms[0] if mod is jprep else rooms[1]
    return [nag, nag]


@pytest.mark.parametrize('train', [False, True], ids=['eval', 'train'])
@pytest.mark.parametrize('source', ['random', 'room'])
def test_prepare_batch_matches_jax(rooms, source, train):
    def run(mod):
        rng = np.random.default_rng(0)
        return mod.prepare_batch(_nags(rooms, source, mod),
                                 mod.BatchConfig(), train=train, rng=rng,
                                 **({'device': False} if mod is jprep
                                    else {}))

    ref, got = run(jprep), run(tprep)
    assert_padded_equal(got, ref)
    assert got.levels[1].nbr_in_idx is not None


def test_prepare_batch_to_a_device(rooms):
    """Given a device, prepare_batch returns the host batch through
    from_numpy: tensors, level 1's node ids kept on the host."""
    cfg = tprep.BatchConfig()
    host = tprep.prepare_batch([rooms[1]], cfg, train=False)
    dev = tprep.prepare_batch([rooms[1]], cfg, train=False, device='cpu')
    for h, d in zip(host.levels, dev.levels):
        np.testing.assert_array_equal(d.pos.numpy(), h.pos)
        assert d.y is None and d.nbr_in_idx is None
    np.testing.assert_array_equal(dev.level1_node_id,
                                  host.levels[1].node_id)


def test_prepare_batch_to_a_device_for_training(rooms):
    """A training batch carries the label histograms and the transpose
    neighbor tables to the device (the k/v gathers' backward reads
    them), bit-equal to the host batch's."""
    cfg = tprep.BatchConfig()
    host = tprep.prepare_batch([rooms[1]], cfg, train=True,
                               rng=np.random.default_rng(0))
    dev = tprep.prepare_batch([rooms[1]], cfg, train=True,
                              rng=np.random.default_rng(0), device='cpu')
    for i, (h, d) in enumerate(zip(host.levels, dev.levels)):
        assert d.y is not None
        if i == 0:
            assert d.nbr_in_idx is None
            continue
        for name in ('nbr_idx', 'nbr_in_idx', 'nbr_in_mask'):
            np.testing.assert_array_equal(getattr(d, name).numpy(),
                                          getattr(h, name))
        assert d.nbr_in_idx.dtype == torch.int64


def test_batch_signature_and_discover_caps_match_jax(rooms):
    def run(mod):
        cfg = dataclasses.replace(mod.BatchConfig(),
                                  **jinf.EVAL_BATCH_OVERRIDES)
        nag = rooms[0] if mod is jprep else rooms[1]
        sig = mod.batch_signature(
            mod.process_batch([nag], cfg, train=False), cfg)
        caps = mod.discover_caps([_nags(rooms, 'random', mod)] * 2,
                                 mod.BatchConfig(), train=True,
                                 rng=np.random.default_rng(0))
        return sig, (caps.node_caps, caps.k_caps, caps.k_in_caps)

    assert run(tprep) == run(jprep)


def test_preprocess_cloud_matches_jax(rooms):
    ref, got, _ = rooms
    assert got.num_levels == ref.num_levels == 4
    assert_nags_equal(got, ref, PRE_RTOL)


@pytest.mark.parametrize('k_step', [-1, 4], ids=['native', 'multiscale'])
def test_geometric_features_match_jax(rooms, k_step):
    """Point features from a 20-NN table with -1 at invalid slots: the
    native PCA over the whole table, and the numpy search for the
    neighborhood size of least eigenentropy (`k_step >= 0`)."""
    from superpoint_transformer_torch.ops.native import radius_knn
    pos = rooms[1][0].pos
    nbr, _ = radius_knn(pos, r=0.5, k=20)
    kw = dict(k_min=1, k_step=k_step, k_min_search=8)
    got = tgeo.geometric_features_np(pos, nbr, nbr >= 0, **kw)
    ref = jgeo.geometric_features_np(pos, nbr, nbr >= 0, **kw)
    assert sorted(got) == sorted(ref)
    for k in ref:
        assert_arrays_equal(k, got[k], ref[k], PRE_RTOL)


@pytest.mark.parametrize('kw', [dict(graph_builder='delaunay')],
                         ids=['delaunay'])
def test_preprocess_cloud_unported_branches_raise(kw):
    """The branches that raised before the port had them (the Delaunay
    graph) now run and give JAX's NAG; an unknown partition mode still
    raises."""
    raw = tsyn.synthetic_room_cloud(seed=0, n_points=2_000)
    ref = jpre.preprocess_cloud(
        jsyn.synthetic_room_cloud(seed=0, n_points=2_000), **kw)
    assert_nags_equal(tpre.preprocess_cloud(raw.clone(), **kw), ref, 0)
    with pytest.raises(ValueError, match='partition_mode'):
        tpre.preprocess_cloud(raw, partition_mode='grid', **kw)


def test_nag_files_read_across_packages(rooms, tmp_path):
    pytest.importorskip('h5py')
    path = tmp_path / 'room.h5'
    rooms[0].save(path)
    assert_nags_equal(TNAG.load(path), type(rooms[0]).load(path), 0)
    # and a partial load: levels 1+, two keys
    assert_nags_equal(TNAG.load(path, low=1, keys=['pos', 'sub']),
                      type(rooms[0]).load(path, low=1, keys=['pos', 'sub']),
                      0)
    # and the other way: the port writes, the JAX package reads
    back = tmp_path / 'room_port.h5'
    rooms[1].save(back)
    assert_nags_equal(TNAG.load(back), type(rooms[0]).load(back), 0)


@pytest.fixture(scope='module')
def narrow_pair(rooms):
    """A narrow f32 SPT in both packages with the same random weights."""
    cfg = dataclasses.replace(jprep.BatchConfig(),
                              **jinf.EVAL_BATCH_OVERRIDES)
    shapes_batch = jprep.prepare_batch([rooms[0]], cfg, train=False,
                                       device=False)
    jm = JModel(net=JSPT(compute_dtype=None, **NARROW), num_classes=13)
    variables = {'params': _params(jm, shapes_batch)}
    tm = TModel(TSPT(compute_dtype=None, **NARROW), 13)
    load_jax_params(tm, variables['params']).eval()
    return jm, variables, tm


def test_infer_nag_and_e2e_inference_match_jax(rooms, narrow_pair):
    """Level-1 logits of `infer_nag` on each tile within the f32
    tolerance, argmax in NAG order, and `e2e_inference`'s
    full-resolution labels equal wherever the JAX logits' top-2 margin
    exceeds the tolerance."""
    jm, variables, tm = narrow_pair
    raw = rooms[2]
    tiling = (2, 1)
    pred_t, info = tinf.e2e_inference(tm, raw.clone(), pre_cfg=PRE,
                                      tiling=tiling, warmup=False)
    pred_j, _ = jinf.e2e_inference(jm, variables, raw.clone(),
                                   pre_cfg=PRE, tiling=tiling, warmup=False)
    assert info['n_tiles'] == 2 and pred_t.shape == (raw.num_nodes,)
    assert {'timings_sec', 'e2e_sec', 'raw_points_per_sec'} <= set(info)
    assert {'preprocess', 'transfer', 'forward', 'recover'} <= set(
        info['timings_sec'])

    # per tile: the JAX logits, and the margin of each raw point's label
    cfg = dataclasses.replace(jprep.BatchConfig(),
                              **jinf.EVAL_BATCH_OVERRIDES)
    margin = np.empty(raw.num_nodes)
    for tile, idx in tinf.tile_cloud(raw, tiling):
        nag = tpre.preprocess_cloud(tile.clone(), **PRE)
        ref = jinf.infer_nag(jm, variables, nag, cfg, fetch='logits')
        got = tinf.infer_nag(tm, nag, cfg, fetch='logits')
        np.testing.assert_allclose(got, ref, **TOL_F32)
        np.testing.assert_array_equal(
            tinf.infer_nag(tm, nag, cfg), got.argmax(1))
        # the top-2 margin over what the f32 tolerance lets each side
        # move: above 1, both sides have the same argmax
        top2 = np.sort(ref, axis=1)[:, -2:]
        slack = 2 * (TOL_F32['atol'] + TOL_F32['rtol'] * np.abs(top2[:, 1]))
        voxel = ((top2[:, 1] - top2[:, 0]) / slack)[nag[0].super_index]
        full = np.empty(nag[0].sub.num_items)
        full[nag[0].sub.points] = np.repeat(voxel, nag[0].sub.sizes)
        margin[idx] = full
    sure = margin > 1
    assert sure.mean() > 0.9
    np.testing.assert_array_equal(pred_t[sure], pred_j[sure])


def test_infer_nag_fetch_must_be_argmax_or_logits(rooms, narrow_pair):
    with pytest.raises(ValueError):
        tinf.infer_nag(narrow_pair[2], rooms[1], tprep.BatchConfig(),
                       fetch='device')
