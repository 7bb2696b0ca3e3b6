"""The port's raw-data readers vs the JAX package's: `read_ply` on ascii,
binary little- and big-endian files (an ascii list property included;
binary lists raise in both), the DALES, KITTI-360 and ScanNet readers
on the files of tests/test_datasets.py's reader tests and on the port's
synthetic raw writers, the colour functions and `synthetic_aerial_cloud`.
The readers and the generator are host numpy and must be equal bit for
bit; hsv and lab are compared at 1e-6 (f32 arithmetic of values in
[0, 1])."""
import json

import numpy as np
import pytest

from superpoint_transformer_tpu.data.data import Data as JData
from superpoint_transformer_tpu.datasets import dales as jdales
from superpoint_transformer_tpu.datasets import kitti360 as jkitti
from superpoint_transformer_tpu.datasets import scannet as jscannet
from superpoint_transformer_tpu.transforms import color as jcolor
from superpoint_transformer_tpu.utils import ply as jply
from superpoint_transformer_tpu.utils import synthetic as jsyn
from superpoint_transformer_torch.data.data import Data as TData
from superpoint_transformer_torch.datasets import dales as tdales
from superpoint_transformer_torch.datasets import kitti360 as tkitti
from superpoint_transformer_torch.datasets import scannet as tscannet
from superpoint_transformer_torch.transforms import color as tcolor
from superpoint_transformer_torch.utils import ply as tply
from superpoint_transformer_torch.utils import synthetic as tsyn

COLOR_TOL = dict(rtol=0, atol=1e-6)


def assert_data_equal(got, ref):
    """Every field of two `Data`, bit for bit, with its dtype."""
    assert sorted(got.keys()) == sorted(ref.keys())
    for k in ref.keys():
        a, b = np.asarray(got[k]), np.asarray(ref[k])
        assert a.dtype == b.dtype and a.shape == b.shape, k
        np.testing.assert_array_equal(a, b, err_msg=k)


def _columns(rng, n):
    return {'x': rng.normal(size=n).astype(np.float32),
            'y': rng.normal(size=n).astype(np.float64),
            'z': rng.integers(-5, 5, n).astype(np.int16),
            'red': rng.integers(0, 255, n).astype(np.uint8),
            'label': rng.integers(0, 40, n).astype(np.uint32)}


_TYPE = {'float32': 'float', 'float64': 'double', 'int16': 'short',
         'uint8': 'uchar', 'uint32': 'uint'}


def _write(path, cols, fmt, faces=None):
    """A PLY file of `cols` in `fmt` ('ascii', 'binary_little_endian' or
    'binary_big_endian'), with a 'face' element of list rows when given."""
    n = len(next(iter(cols.values())))
    head = [b'ply', f'format {fmt} 1.0'.encode(), b'comment synthetic',
            f'element vertex {n}'.encode()]
    head += [f'property {_TYPE[v.dtype.name]} {k}'.encode()
             for k, v in cols.items()]
    if faces is not None:
        head += [f'element face {len(faces)}'.encode(),
                 b'property list uchar int vertex_indices']
    head.append(b'end_header')
    with open(path, 'wb') as f:
        f.write(b'\n'.join(head) + b'\n')
        if fmt == 'ascii':
            for i in range(n):
                f.write(' '.join(str(v[i]) for v in cols.values()).encode()
                        + b'\n')
            for row in faces or ():
                f.write(' '.join(str(v) for v in [len(row)] + row).encode()
                        + b'\n')
        else:
            end = '<' if 'little' in fmt else '>'
            dt = np.dtype([(k, end + v.dtype.str[1:]) for k, v in
                           cols.items()])
            rec = np.zeros(n, dt)
            for k, v in cols.items():
                rec[k] = v
            f.write(rec.tobytes())
            for row in faces or ():
                f.write(np.uint8(len(row)).tobytes()
                        + np.asarray(row, end + 'i4').tobytes())


def _assert_ply_equal(got, ref):
    assert list(got) == list(ref)
    for name, r in ref.items():
        g = got[name]
        if isinstance(r, list):
            assert g == r
            continue
        assert g.dtype == r.dtype and g.flags.writeable
        for field in r.dtype.names:
            np.testing.assert_array_equal(g[field], r[field])


@pytest.mark.parametrize('fmt', ['ascii', 'binary_little_endian',
                                 'binary_big_endian'])
def test_read_ply_equals_jax(tmp_path, fmt):
    path = str(tmp_path / 'cloud.ply')
    _write(path, _columns(np.random.default_rng(0), 37), fmt)
    _assert_ply_equal(tply.read_ply(path), jply.read_ply(path))


def test_read_ply_list_property_as_jax(tmp_path):
    cols = _columns(np.random.default_rng(1), 9)
    faces = [[0, 1, 2], [2, 3, 4, 5], [6, 7, 8]]
    path = str(tmp_path / 'ascii.ply')
    _write(path, cols, 'ascii', faces)
    got, ref = tply.read_ply(path), jply.read_ply(path)
    _assert_ply_equal(got, ref)
    assert got['face'][1] == [b'4', b'2', b'3', b'4', b'5']
    path = str(tmp_path / 'binary.ply')
    _write(path, cols, 'binary_little_endian', faces)
    for read in (tply.read_ply, jply.read_ply):
        with pytest.raises(NotImplementedError, match='list'):
            read(path)


def test_write_ply_byte_equal_jax(tmp_path):
    cols = _columns(np.random.default_rng(2), 50)
    tply.write_ply(str(tmp_path / 'port.ply'), cols, comments=('a',))
    jply.write_ply(str(tmp_path / 'jax.ply'), cols, comments=('a',))
    assert (tmp_path / 'port.ply').read_bytes() == \
        (tmp_path / 'jax.ply').read_bytes()


# the raw files of tests/test_datasets.py's reader tests
def _dales_file(tmp_path):
    rng = np.random.default_rng(0)
    n = 200
    d = {'x': rng.uniform(0, 10, n).astype(np.float32),
         'y': rng.uniform(0, 10, n).astype(np.float32),
         'z': rng.uniform(0, 5, n).astype(np.float32),
         'intensity': rng.uniform(0, 60000, n).astype(np.float32),
         'sem_class': rng.integers(0, 9, n).astype(np.uint8),
         'ins_class': rng.integers(0, 5, n).astype(np.int32)}
    p = str(tmp_path / 'tile.ply')
    jply.write_ply(p, d)
    return p


def _kitti360_file(tmp_path):
    rng = np.random.default_rng(0)
    n = 150
    d = {'x': rng.uniform(0, 50, n).astype(np.float32),
         'y': rng.uniform(0, 50, n).astype(np.float32),
         'z': rng.uniform(0, 10, n).astype(np.float32),
         'red': rng.integers(0, 255, n).astype(np.uint8),
         'green': rng.integers(0, 255, n).astype(np.uint8),
         'blue': rng.integers(0, 255, n).astype(np.uint8),
         'semantic': rng.integers(0, 45, n).astype(np.int32),
         'instance': rng.integers(0, 9, n).astype(np.int32)}
    p = str(tmp_path / 'win.ply')
    jply.write_ply(p, d)
    return p


def _scannet_dir(tmp_path):
    rng = np.random.default_rng(0)
    n = 120
    scan = 'scene0000_00'
    sdir = tmp_path / scan
    sdir.mkdir()
    base = {'x': rng.uniform(0, 6, n).astype(np.float32),
            'y': rng.uniform(0, 6, n).astype(np.float32),
            'z': rng.uniform(0, 3, n).astype(np.float32),
            'red': rng.integers(0, 255, n).astype(np.uint8),
            'green': rng.integers(0, 255, n).astype(np.uint8),
            'blue': rng.integers(0, 255, n).astype(np.uint8)}
    jply.write_ply(str(sdir / f'{scan}_vh_clean_2.ply'), base)
    jply.write_ply(str(sdir / f'{scan}_vh_clean_2.labels.ply'),
                   {**base, 'label': rng.integers(0, 41, n).astype(
                       np.uint16)})
    with open(sdir / f'{scan}_vh_clean_2.0.010000.segs.json', 'w') as f:
        json.dump({'segIndices': (np.arange(n) // 10).tolist()}, f)
    with open(sdir / f'{scan}.aggregation.json', 'w') as f:
        json.dump({'segGroups': [
            {'objectId': 0, 'segments': [0, 1]},
            {'objectId': 1, 'segments': [2, 3, 4]}]}, f)
    return str(sdir)


READERS = {
    'dales': (_dales_file, tdales.read_dales_tile, jdales.read_dales_tile,
              [{}, {'instance': True}, {'remap': False},
               {'intensity': False, 'semantic': False}]),
    'kitti360': (_kitti360_file, tkitti.read_kitti360_window,
                 jkitti.read_kitti360_window,
                 [{}, {'instances': True}]),
    'scannet': (_scannet_dir, tscannet.read_scannet_scan,
                jscannet.read_scannet_scan,
                [{}, {'instances': True}])}


@pytest.mark.parametrize('name', sorted(READERS))
def test_reader_equals_jax(tmp_path, name):
    make, read, jread, options = READERS[name]
    path = make(tmp_path)
    for kw in options:
        got, ref = read(path, **kw), jread(path, **kw)
        assert isinstance(got, TData)
        assert_data_equal(got, ref)
    if name == 'scannet':
        obj = read(path, instances=True).obj
        assert (obj[:20] == 0).all() and (obj[50:] == -1).all()


def test_reader_maps_equal_jax():
    np.testing.assert_array_equal(tdales.DALES_ID2TRAINID,
                                  jdales.DALES_ID2TRAINID)
    assert tdales.DALES_TILES == jdales.DALES_TILES
    np.testing.assert_array_equal(tkitti._ID2TRAIN, jkitti._ID2TRAIN)
    np.testing.assert_array_equal(tkitti.KITTI360_TRAINID2ID,
                                  jkitti.KITTI360_TRAINID2ID)
    assert tkitti.KITTI360.submission_id_map.dtype == np.uint8
    np.testing.assert_array_equal(tkitti.KITTI360.submission_id_map,
                                  jkitti.KITTI360.submission_id_map)
    np.testing.assert_array_equal(tscannet._NYU40_TO_TRAIN,
                                  jscannet._NYU40_TO_TRAIN)
    np.testing.assert_array_equal(tscannet.ScanNet.submission_id_map,
                                  jscannet.ScanNet.submission_id_map)
    for t, j in ((tdales.DALES, jdales.DALES),
                 (tkitti.KITTI360, jkitti.KITTI360),
                 (tscannet.ScanNet, jscannet.ScanNet)):
        assert (t.class_names, t.num_classes, t.stuff_classes) == \
            (j.class_names, j.num_classes, j.stuff_classes)


@pytest.mark.parametrize('name', ['dales', 'kitti360', 'scannet'])
def test_synthetic_raw_files_read_as_in_jax(tmp_path, name):
    """The port's writers of synthetic raw files: both packages' readers
    give the same fields, with the labels and instances that the writer
    put in."""
    if name == 'scannet':
        cloud = tsyn.synthetic_room_cloud(seed=3, n_points=4000)
        path = str(tmp_path / 'scene0003_00')
        tsyn.write_scannet_scan(path, cloud)
        kw = {'instances': True}
    else:
        cloud, planted = tsyn.synthetic_aerial_cloud(seed=3, n_points=4000)
        cloud['planted'] = planted
        path = str(tmp_path / 'cloud.ply')
        write = (tsyn.write_dales_tile if name == 'dales'
                 else tsyn.write_kitti360_window)
        write(path, cloud)
        kw = {'instance' if name == 'dales' else 'instances': True}
    read, jread = READERS[name][1:3]
    got = read(path, **kw)
    assert_data_equal(got, jread(path, **kw))
    np.testing.assert_array_equal(got.pos, cloud.pos)
    if name == 'dales':
        np.testing.assert_array_equal(got.y, tdales.DALES_ID2TRAINID[
            tsyn.AERIAL_TO_DALES[cloud.y]])
        np.testing.assert_array_equal(got.obj, planted)
        assert 0 <= got.intensity.min() and got.intensity.max() <= 1
    elif name == 'kitti360':
        np.testing.assert_array_equal(got.y, tkitti._ID2TRAIN[
            tsyn.AERIAL_TO_KITTI360[cloud.y]])
        assert got.rgb.dtype == np.uint8
    else:
        np.testing.assert_array_equal(got.y, tscannet._NYU40_TO_TRAIN[
            tsyn.ROOM_TO_NYU40[cloud.y]])
        ceiling = cloud.y == 1
        assert (got.obj[ceiling] == -1).all()
        assert (got.obj[~ceiling] >= 0).all()
        # one object id per room instance
        inst = tsyn.room_instances(cloud)
        for o in np.unique(got.obj[~ceiling]):
            assert np.unique(inst[got.obj == o]).size == 1


def test_synthetic_aerial_cloud_equals_jax():
    for seed, n in ((0, 5000), (7, 12_345)):
        got, planted = tsyn.synthetic_aerial_cloud(seed=seed, n_points=n)
        ref, jplanted = jsyn.synthetic_aerial_cloud(seed=seed, n_points=n)
        assert isinstance(got, TData)
        assert_data_equal(got, ref)
        np.testing.assert_array_equal(planted, jplanted)
        assert planted.dtype == jplanted.dtype


def _rgb(seed, n=500):
    rng = np.random.default_rng(seed)
    rgb = rng.random((n, 3)).astype(np.float32)
    rgb[:10] = rgb[:10, :1]                 # greys: no hue
    rgb[10:20, 0] = rgb[10:20, 1]           # ties between channels
    rgb[20] = 0
    return rgb


def test_color_conversions_equal_jax():
    for seed in range(3):
        rgb = _rgb(seed)
        for fn in ('rgb_to_hsv', 'rgb_to_lab'):
            got = getattr(tcolor, fn)(rgb)
            ref = getattr(jcolor, fn)(rgb)
            assert got.dtype == ref.dtype == np.float32
            np.testing.assert_allclose(got, ref, **COLOR_TOL)


@pytest.mark.parametrize('scale', [1, 255], ids=['float', 'uint8'])
def test_color_features_and_positions_equal_jax(scale):
    rgb = _rgb(4) * scale
    if scale == 255:
        rgb = np.round(rgb).astype(np.uint8)
    pos = np.random.default_rng(5).normal(size=(500, 3)).astype(np.float32)

    def run(mod, cls):
        d = mod.add_color_features(cls(pos=pos.copy(), rgb=rgb.copy()),
                                   keys=('hsv', 'lab'))
        d = mod.room_position(mod.center_position(d))
        return mod.color_normalize(d)

    got, ref = run(tcolor, TData), run(jcolor, JData)
    assert sorted(got.keys()) == sorted(ref.keys())
    for k in ('hsv', 'lab'):
        np.testing.assert_allclose(got[k], ref[k], **COLOR_TOL)
    for k in ('pos', 'pos_room', 'pos_offset', 'rgb'):
        np.testing.assert_array_equal(got[k], ref[k], err_msg=k)
    # a cloud without colours passes through
    d = tcolor.add_color_features(TData(pos=pos.copy()))
    assert 'hsv' not in d.keys()
