"""The port's datasets and loaders vs the JAX package's, on a raw S3DIS
layout of a few thousand points per room (the fixture of
tests/test_datasets.py) and, in the same raw tree, DALES tiles,
KITTI-360 windows and ScanNet scans of 4,000 synthetic points each
(written by the port's `utils/synthetic.py`): cloud ids, the
preprocessing hash and paths per stage and fold, the processed HDF5 files
field by field (one 4-level cloud of each new dataset, preprocessed with
its experiment's own configuration), caches read across packages, class
weights, loader order, the prepared loader's workers, tiling, the
room-level dataset, the in-memory cache and the submission files.
Everything here is host numpy and must be equal: no tolerance."""
import os
import os.path as osp

import h5py
import numpy as np
import pytest

from superpoint_transformer_tpu import datasets as jds
from superpoint_transformer_tpu.config.loader import _to_config
from superpoint_transformer_tpu.data import Data as JData
from superpoint_transformer_tpu.datasets import base as jbase
from superpoint_transformer_tpu.experiment import (
    _pre_transform_config as jpre_cfg)
from superpoint_transformer_tpu.transforms import prepare as jprep
from superpoint_transformer_tpu.transforms import preprocess as jpre
from superpoint_transformer_torch import datasets as tds
from superpoint_transformer_torch.data.data import Data as TData
from superpoint_transformer_torch.datasets import base as tbase
from superpoint_transformer_torch.experiment import (
    DALES_CFG, FLAGSHIP_CFG, KITTI360_CFG, PANOPTIC_CFG,
    PANOPTIC_SCANNET_CFG, _pre_transform_config as tpre_cfg)
from superpoint_transformer_torch.transforms import prepare as tprep
from superpoint_transformer_torch.transforms import preprocess as tpre
from superpoint_transformer_torch.utils import synthetic as tsyn
from test_datasets import PRE_CFG, make_raw_s3dis
from test_torch_host_path import assert_nags_equal, assert_padded_equal
from test_torch_trainer import one_torch_thread  # noqa: F401

AREAS = ('Area_1', 'Area_2', 'Area_5')
N_PER_OBJ = 750      # 4 objects: 3,000 points a room
# the prepared loader's workers get a deadline of their own, so that a
# hang fails this test instead of eating the suite's time limit
WORKER_TIMEOUT_S = 120
# raw points of each synthetic DALES tile, KITTI-360 window and ScanNet
# scan: 4 levels under each experiment's own preprocessing
OTHER_POINTS = 4000
KITTI360_WINDOWS = {
    'train': '2013_05_28_drive_0000_sync/0000000002_0000000385',
    'val': '2013_05_28_drive_0002_sync/0000004391_0000004625',
    'test': '2013_05_28_drive_0008_sync/0000000002_0000000245'}
SCANNET_SPLITS = {'train': ['scene0000_00', 'scene0001_00'],
                  'val': ['scene0002_00'], 'test': ['scene0707_00']}


def write_other_raw(root, n_points=OTHER_POINTS):
    """MiniDALES's 6 tiles, a KITTI-360 window for each split, and 4
    ScanNet scans (one in `scans_test`) with their split files, under
    `root`/raw."""
    raw = osp.join(root, 'raw')
    os.makedirs(raw, exist_ok=True)
    seed = 0
    for split, tiles in tds.dales.DALES_TILES.items():
        for t in tiles[:2]:
            cloud, planted = tsyn.synthetic_aerial_cloud(seed=seed,
                                                         n_points=n_points)
            cloud['planted'] = planted
            tsyn.write_dales_tile(osp.join(raw, f'{t}.ply'), cloud)
            seed += 1
    for split, window in KITTI360_WINDOWS.items():
        seq, win = window.split('/')
        d = osp.join(raw, 'data_3d_semantics', split, seq, 'static')
        os.makedirs(d)
        cloud, _ = tsyn.synthetic_aerial_cloud(seed=seed, n_points=n_points)
        tsyn.write_kitti360_window(osp.join(d, f'{win}.ply'), cloud)
        seed += 1
    for split, scans in SCANNET_SPLITS.items():
        for scan in scans:
            tsyn.write_scannet_scan(
                osp.join(raw, 'scans_test' if split == 'test' else 'scans',
                         scan),
                tsyn.synthetic_room_cloud(seed=seed, n_points=n_points))
            seed += 1
        with open(osp.join(raw, f'scannetv2_{split}.txt'), 'w') as f:
            f.write('\n'.join(scans) + '\n')


@pytest.fixture(scope='module')
def raw_root(tmp_path_factory):
    root = str(tmp_path_factory.mktemp('s3dis_raw'))
    make_raw_s3dis(root, areas=AREAS, rooms=2, n_per_obj=N_PER_OBJ)
    write_other_raw(root)
    return root


def _root_with_raw(tmp_path_factory, raw_root, name):
    root = str(tmp_path_factory.mktemp(name))
    os.symlink(osp.join(raw_root, 'raw'), osp.join(root, 'raw'))
    return root


@pytest.fixture(scope='module')
def roots(tmp_path_factory, raw_root):
    """{'jax': root, 'port': root}: the same raw files, MiniS3DIS's
    train and test clouds processed by each package."""
    out = {}
    for name, mod in (('jax', jds), ('port', tds)):
        out[name] = _root_with_raw(tmp_path_factory, raw_root, name)
        for stage in ('train', 'test'):
            mod.MiniS3DIS(out[name], fold=5, stage=stage,
                          pre_transform_config=PRE_CFG).process()
    return out


def _pair(cls_name, root, **kw):
    return (getattr(tds, cls_name)(root, **kw),
            getattr(jds, cls_name)(root, **kw))


STAGES = ('train', 'val', 'trainval', 'test')
# (fold, stage, class): the S3DIS datasets at folds 1 and 5, the others
# (no fold) at every stage
ID_CASES = [pytest.param(fold, stage, cls, id=f'{fold}-{stage}-{cls}')
            for fold in (1, 5) for stage in STAGES
            for cls in ('S3DIS', 'MiniS3DIS', 'S3DISRoom', 'MiniS3DISRoom')]
ID_CASES += [pytest.param(None, stage, cls, id=f'{stage}-{cls}')
             for stage in STAGES
             for cls in ('DALES', 'MiniDALES', 'KITTI360', 'MiniKITTI360',
                         'ScanNet', 'MiniScanNet')]


@pytest.mark.parametrize('fold,stage,cls_name', ID_CASES)
def test_ids_hash_and_paths_equal_jax(raw_root, cls_name, stage, fold):
    cfg = dict(PRE_CFG, with_instances=True) if fold == 1 else PRE_CFG
    kw = {} if fold is None else {'fold': fold}
    got, ref = _pair(cls_name, raw_root, stage=stage,
                     pre_transform_config=cfg, **kw)
    assert got.cloud_ids == ref.cloud_ids and got.cloud_ids
    assert got.pre_transform_hash == ref.pre_transform_hash
    assert got.processed_paths == ref.processed_paths
    assert got.all_cloud_ids == ref.all_cloud_ids


@pytest.mark.parametrize('cfg', [FLAGSHIP_CFG, PANOPTIC_CFG, DALES_CFG,
                                 KITTI360_CFG, PANOPTIC_SCANNET_CFG],
                         ids=['flagship', 'panoptic', 'dales', 'kitti360',
                              'panoptic_scannet'])
def test_pre_transform_config_and_hash_equal_jax(raw_root, cfg):
    got, ref = tpre_cfg(cfg), jpre_cfg(_to_config(cfg))
    assert repr(sorted(got.items())) == repr(sorted(ref.items()))
    cls_name = {'s3dis': 'S3DIS', 'dales': 'DALES', 'kitti360': 'KITTI360',
                'scannet': 'ScanNet'}[cfg['datamodule']['dataset']]
    a, b = _pair(cls_name, raw_root, pre_transform_config=got)
    assert a.pre_transform_hash == b.pre_transform_hash


def _h5_fields(path):
    out = {}
    with h5py.File(path, 'r') as f:
        out['attrs'] = dict(f.attrs)

        def visit(name, obj):
            if isinstance(obj, h5py.Dataset):
                out[name] = obj[()]
        f.visititems(visit)
    return out


# one cloud of each new dataset, preprocessed as its experiment says
# (ScanNet with the panoptic experiment's instances)
OTHER_PROCESSED = {'dales': ('MiniDALES', DALES_CFG),
                   'kitti360': ('MiniKITTI360', KITTI360_CFG),
                   'scannet': ('MiniScanNet', PANOPTIC_SCANNET_CFG)}


def _other_paths(tmp_path_factory, raw_root, name):
    """{'jax': path, 'port': path} of the first training cloud of `name`
    processed by each package (in a root of its own), and the NAG."""
    cls_name, cfg = OTHER_PROCESSED[name]
    kw = dict(stage='train', pre_transform_config=tpre_cfg(cfg),
              instances=bool(cfg['datamodule']['instance']))
    out = {}
    for pkg, mod in (('jax', jds), ('port', tds)):
        ds = getattr(mod, cls_name)(
            _root_with_raw(tmp_path_factory, raw_root, f'{name}_{pkg}'), **kw)
        cloud = ds.cloud_ids[0]
        ds._process_single_cloud(cloud)
        out[pkg] = ds.processed_path(cloud)
        if pkg == 'port':
            nag = ds.load(cloud)
    assert nag.num_levels == 4, name
    keys = nag[0].keys()
    assert ('intensity' in keys) == (name == 'dales')
    assert ('obj' in keys) == (name == 'scannet')
    if name == 'scannet':
        # the ceiling's vertices belong to no ScanNet group: object -1
        ids = nag[0].obj.obj
        assert (ids == -1).any() and (ids >= 0).any()
    return out['port'], {out['port']: out['jax']}


@pytest.mark.parametrize('dataset', ['s3dis', 'dales', 'kitti360',
                                     'scannet'])
def test_processed_files_bit_equal_jax(tmp_path_factory, raw_root, roots,
                                       dataset):
    if dataset == 's3dis':
        ds = tds.MiniS3DIS(roots['port'], fold=5, stage='train',
                           pre_transform_config=PRE_CFG)
        paths = [p for s in ('train', 'test') for p in tds.MiniS3DIS(
            roots['port'], fold=5, stage=s,
            pre_transform_config=PRE_CFG).processed_paths]
        assert len(paths) == 2 and ds.pre_transform_hash in paths[0]
        refs = {p: p.replace(roots['port'], roots['jax']) for p in paths}
    else:
        path, refs = _other_paths(tmp_path_factory, raw_root, dataset)
        paths = [path]
    for path in paths:
        got = _h5_fields(path)
        ref = _h5_fields(refs[path])
        assert sorted(got) == sorted(ref)
        for key, value in ref.items():
            if key == 'attrs':
                assert got[key] == value
            else:
                assert got[key].dtype == value.dtype, key
                np.testing.assert_array_equal(got[key], value, err_msg=key)


@pytest.mark.parametrize('direction', ['jax_root_in_port',
                                       'port_root_in_jax'])
def test_processed_roots_load_across_packages(roots, direction):
    src = roots['jax' if direction == 'jax_root_in_port' else 'port']
    for stage in ('train', 'test'):
        got, ref = _pair('MiniS3DIS', src, fold=5, stage=stage,
                         pre_transform_config=PRE_CFG)
        for i in range(len(ref)):
            assert_nags_equal(got[i], ref[i], 0)


def test_class_weights_equal_jax(roots):
    got, ref = _pair('MiniS3DIS', roots['port'], fold=5, stage='train',
                     pre_transform_config=PRE_CFG)
    w = got.get_class_weight()
    assert w.dtype == np.float32
    np.testing.assert_array_equal(w, ref.get_class_weight())
    np.testing.assert_array_equal(got.get_class_weight('log'),
                                  ref.get_class_weight('log'))


def test_dataloader_order_equal_jax(raw_root):
    n = 7
    for shuffle, drop in ((True, False), (True, True), (False, False)):
        got = tbase.DataLoader(list(range(n)), batch_size=3,
                               shuffle=shuffle, seed=4, drop_last=drop)
        ref = jbase.DataLoader(list(range(n)), batch_size=3,
                               shuffle=shuffle, seed=4, drop_last=drop)
        assert len(got) == len(ref)
        for _ in range(3):   # the shuffle changes with the epoch
            assert list(got) == list(ref)


def test_prepared_loader_workers_equal_serial_and_jax(roots):
    """Two worker processes give the serial path's batches, and the
    serial path gives the JAX PreparedDataLoader's, field by field."""
    root = roots['port']
    ds = tds.MiniS3DIS(root, fold=5, stage='trainval',
                       pre_transform_config=PRE_CFG)
    cfg = tprep.discover_caps([[ds[0], ds[1]]], tprep.BatchConfig())
    kw = dict(batch_size=1, shuffle=True, seed=3, train=True)
    serial = tbase.PreparedDataLoader(ds, cfg, **kw)
    pool = tbase.PreparedDataLoader(ds, cfg, num_workers=2,
                                    timeout=WORKER_TIMEOUT_S, **kw)
    try:
        for _ in range(2):   # the pool persists across epochs
            got, ref = list(pool), list(serial)
            assert len(got) == len(ref) == len(ds)
            for a, b in zip(got, ref):
                for la, lb in zip(a.levels, b.levels):
                    for f, va in vars(la).items():
                        vb = getattr(lb, f)
                        assert (va is None) == (vb is None), f
                        if va is not None and f != 'num_nodes':
                            assert va.equal(vb), f
    finally:
        pool.close()

    # the port's batch preparation of each loader batch is JAX's
    jcfg = jprep.discover_caps([[jds.MiniS3DIS(
        root, fold=5, stage='trainval', pre_transform_config=PRE_CFG)[i]
        for i in range(2)]], jprep.BatchConfig())
    assert jcfg.node_caps == cfg.node_caps and jcfg.k_caps == cfg.k_caps
    # the loader draws its epoch-0 seeds after counting the epoch
    seeds = np.random.SeedSequence(3 + 7919).generate_state(len(ds))
    order = list(tbase.DataLoader(list(range(len(ds))), shuffle=True,
                                  seed=3))
    for bid, idx in enumerate(order):
        nags = [ds[int(j)] for j in idx]
        got = tprep.prepare_batch(nags, cfg, train=True,
                                  rng=np.random.default_rng(int(seeds[bid])))
        ref = jprep.prepare_batch(nags, jcfg, train=True, device=False,
                                  rng=np.random.default_rng(int(seeds[bid])))
        assert_padded_equal(got, ref)


def _cloud(mod, seed=0, n=3000):
    rng = np.random.default_rng(seed)
    pos = rng.uniform(0, 10, (n, 3)).astype(np.float32)
    pos[:, 0] *= 3    # elongated, so the principal axis is x
    return (JData if mod == 'jax' else TData)(
        pos=pos, y=rng.integers(0, 13, n))


@pytest.mark.parametrize('tiling', [(2, 2), 3, (3, 1)])
def test_xy_tiling_equals_jax(tiling):
    tx, ty = (tiling, tiling) if np.isscalar(tiling) else tiling
    sizes = 0
    for i in range(tx):
        for j in range(ty):
            got = tpre.sample_xy_tiling(_cloud('port'), tiling, (i, j))
            ref = jpre.sample_xy_tiling(_cloud('jax'), tiling, (i, j))
            np.testing.assert_array_equal(got.pos, ref.pos)
            np.testing.assert_array_equal(got.y, ref.y)
            sizes += got.num_nodes
    assert sizes == 3000


@pytest.mark.parametrize('steps', [1, 2])
def test_recursive_main_axis_tiling_equals_jax(steps):
    for tile in range(1 << steps):
        got = tpre.sample_recursive_main_xy_axis_tiling(
            _cloud('port'), steps, tile)
        ref = jpre.sample_recursive_main_xy_axis_tiling(
            _cloud('jax'), steps, tile)
        np.testing.assert_array_equal(got.pos, ref.pos)


def test_xy_tiled_dataset_processes_as_jax(tmp_path_factory, raw_root):
    """A dataset tiled 2 x 1 in XY: the tile ids, and each processed
    tile's NAG, are JAX's."""
    kw = dict(fold=5, stage='test', pre_transform_config=PRE_CFG,
              xy_tiling=(2, 1))
    got = tds.MiniS3DIS(
        _root_with_raw(tmp_path_factory, raw_root, 'tile_port'), **kw)
    ref = jds.MiniS3DIS(
        _root_with_raw(tmp_path_factory, raw_root, 'tile_jax'), **kw)
    assert got.cloud_ids == ref.cloud_ids == \
        ['Area_5__TILE_0-0', 'Area_5__TILE_1-0']
    got.process()
    ref.process()
    for i in range(2):
        assert_nags_equal(got[i], ref[i], 0)


def test_room_dataset_and_in_memory_as_jax(tmp_path_factory, raw_root):
    """MiniS3DISRoom: rooms as clouds, processed as JAX processes them;
    `in_memory` returns the same object on a second read, and the plain
    dataset a fresh one."""
    kw = dict(fold=5, stage='train', pre_transform_config=PRE_CFG)
    got = tds.MiniS3DISRoom(
        _root_with_raw(tmp_path_factory, raw_root, 'room_port'),
        in_memory=True, **kw)
    ref = jds.MiniS3DISRoom(
        _root_with_raw(tmp_path_factory, raw_root, 'room_jax'), **kw)
    assert got.cloud_ids == ref.cloud_ids == \
        ['Area_1/office_1', 'Area_1/office_2']
    got.process()
    ref.process()
    for i in range(len(ref)):
        assert_nags_equal(got[i], ref[i], 0)
    assert got[0] is got[0]
    plain = tds.MiniS3DISRoom(got.root, **kw)
    assert plain[0] is not plain[0]
    assert_nags_equal(plain[0], got[0], 0)


class _Fake:
    def __init__(self, fmt, idmap=None):
        self.submission_format = fmt
        if idmap is not None:
            self.submission_id_map = idmap


@pytest.mark.parametrize('fmt,idmap,cloud_id', [
    ('labels_txt', None, 'Area_5'),
    ('labels_txt', np.arange(13) * 3, 'Area_5'),
    ('kitti360_npy', np.arange(13) + 7,
     '2013_05_28_drive_0008_sync/0000000002_0000000385'),
    ('labels_ply', None, 'Area_5'),
    ('kitti360_npy', tds.KITTI360.submission_id_map,
     '2013_05_28_drive_0000_sync/0000000002_0000000385'),
    ('labels_txt', tds.ScanNet.submission_id_map, 'scene0000_00')])
def test_make_submission_files_byte_equal_jax(tmp_path, fmt, idmap,
                                              cloud_id):
    pred = np.random.default_rng(0).integers(0, 13, 500)
    got = tbase.make_submission(_Fake(fmt, idmap), cloud_id, pred,
                                str(tmp_path / 'port'))
    ref = jbase.make_submission(_Fake(fmt, idmap), cloud_id, pred,
                                str(tmp_path / 'jax'))
    assert osp.basename(got) == osp.basename(ref)
    with open(got, 'rb') as a, open(ref, 'rb') as b:
        assert a.read() == b.read()
