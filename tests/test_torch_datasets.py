"""The port's datasets and loaders vs the JAX package's, on a raw S3DIS
layout of a few thousand points per room (the fixture of
tests/test_datasets.py): cloud ids, the preprocessing hash and paths per
stage and fold, the processed HDF5 files field by field, caches read
across packages, class weights, loader order, the prepared loader's
workers, tiling, the room-level dataset, the in-memory cache and the
submission files. Everything here is host numpy and must be equal: no
tolerance."""
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
    FLAGSHIP_CFG, PANOPTIC_CFG, _pre_transform_config as tpre_cfg)
from superpoint_transformer_torch.transforms import prepare as tprep
from superpoint_transformer_torch.transforms import preprocess as tpre
from test_datasets import PRE_CFG, make_raw_s3dis
from test_torch_host_path import assert_nags_equal, assert_padded_equal
from test_torch_trainer import one_torch_thread  # noqa: F401

AREAS = ('Area_1', 'Area_2', 'Area_5')
N_PER_OBJ = 750      # 4 objects: 3,000 points a room
# the prepared loader's workers get a deadline of their own, so that a
# hang fails this test instead of eating the suite's time limit
WORKER_TIMEOUT_S = 120


@pytest.fixture(scope='module')
def raw_root(tmp_path_factory):
    root = str(tmp_path_factory.mktemp('s3dis_raw'))
    make_raw_s3dis(root, areas=AREAS, rooms=2, n_per_obj=N_PER_OBJ)
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


@pytest.mark.parametrize('cls_name', ['S3DIS', 'MiniS3DIS', 'S3DISRoom',
                                      'MiniS3DISRoom'])
@pytest.mark.parametrize('stage', ['train', 'val', 'trainval', 'test'])
@pytest.mark.parametrize('fold', [1, 5])
def test_ids_hash_and_paths_equal_jax(raw_root, cls_name, stage, fold):
    cfg = dict(PRE_CFG, with_instances=True) if fold == 1 else PRE_CFG
    got, ref = _pair(cls_name, raw_root, fold=fold, stage=stage,
                     pre_transform_config=cfg)
    assert got.cloud_ids == ref.cloud_ids and got.cloud_ids
    assert got.pre_transform_hash == ref.pre_transform_hash
    assert got.processed_paths == ref.processed_paths
    assert got.all_cloud_ids == ref.all_cloud_ids


@pytest.mark.parametrize('cfg', [FLAGSHIP_CFG, PANOPTIC_CFG],
                         ids=['flagship', 'panoptic'])
def test_pre_transform_config_and_hash_equal_jax(raw_root, cfg):
    got, ref = tpre_cfg(cfg), jpre_cfg(_to_config(cfg))
    assert repr(sorted(got.items())) == repr(sorted(ref.items()))
    a, b = _pair('S3DIS', raw_root, pre_transform_config=got)
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


def test_processed_files_bit_equal_jax(roots):
    ds = tds.MiniS3DIS(roots['port'], fold=5, stage='train',
                       pre_transform_config=PRE_CFG)
    paths = [p for s in ('train', 'test') for p in tds.MiniS3DIS(
        roots['port'], fold=5, stage=s,
        pre_transform_config=PRE_CFG).processed_paths]
    assert len(paths) == 2 and ds.pre_transform_hash in paths[0]
    for path in paths:
        got = _h5_fields(path)
        ref = _h5_fields(path.replace(roots['port'], roots['jax']))
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
    ('labels_ply', None, 'Area_5')])
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
