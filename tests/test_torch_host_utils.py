"""The port's host-only utilities against the JAX package on the CPU: the
NAG v2 -> v3 converter (a v2 HDF5 written with h5py, converted by each
package: the same arrays, and the same v3 file read back) and the 3D
viewer (`visualize_3d`'s HTML byte-equal under one title, the palette
equal, and a PNG through matplotlib).
"""
import numpy as np
import pytest

from superpoint_transformer_tpu.data import NAG as JNAG
from superpoint_transformer_tpu.utils import backwards_compatibility as jbc
from superpoint_transformer_tpu.utils import synthetic as jsyn
from superpoint_transformer_tpu.visualization import visualization as jvis
from superpoint_transformer_torch.data.nag import NAG as TNAG
from superpoint_transformer_torch.utils import backwards_compatibility as tbc
from superpoint_transformer_torch.utils import synthetic as tsyn
from superpoint_transformer_torch.visualization import visualization as tvis
from test_torch_host_path import assert_nags_equal


def _write_v2(path, float_rgb):
    """A 2-level v2 NAG file: plain, `_csr_`, `_cluster_` and
    `_instance_data_` keys, and batch bookkeeping to drop."""
    h5py = pytest.importorskip('h5py')
    from superpoint_transformer_tpu.data.io import (save_array,
                                                    save_dense_to_csr)
    rng = np.random.default_rng(0)
    n0, n1 = 40, 5
    super_index = np.sort(rng.integers(0, n1, n0)).astype(np.int64)
    y1 = np.zeros((n1, 4), np.int64)
    for i, s in enumerate(super_index):
        y1[s, i % 4] += 1
    order = np.argsort(super_index, kind='stable').astype(np.int64)
    ptr = np.concatenate([[0], np.cumsum(np.bincount(
        super_index, minlength=n1))]).astype(np.int64)
    rgb = rng.random((n0, 3)).astype(np.float32) if float_rgb \
        else rng.integers(0, 255, (n0, 3)).astype(np.uint8)
    with h5py.File(path, 'w') as f:
        g0 = f.create_group('partition_0')
        save_array(rng.normal(size=(n0, 3)).astype(np.float32), g0, 'pos')
        save_array(rgb, g0, 'rgb')
        save_array(super_index, g0, 'super_index')
        g1 = f.create_group('partition_1')
        save_array(rng.normal(size=(n1, 3)).astype(np.float32), g1, 'pos')
        save_dense_to_csr(y1, g1.create_group('_csr_/y'))
        cg = g1.create_group('_cluster_/sub')
        save_array(ptr, cg, 'pointers')
        save_array(order, cg, 'points')
        ig = g1.create_group('_instance_data_/obj')
        save_array(np.arange(n1 + 1, dtype=np.int64), ig, 'pointers')
        for i in range(3):
            save_array(rng.integers(0, 4, n1).astype(np.int64), ig, str(i))
        f.create_dataset('partition_0/_num_graphs', data=np.array([1]))


@pytest.mark.parametrize('float_rgb', [False, True],
                         ids=['byte_rgb', 'float_rgb'])
def test_convert_nag_v2_to_v3_matches_jax(tmp_path, float_rgb):
    src = tmp_path / 'nag_v2.h5'
    _write_v2(src, float_rgb)
    assert_nags_equal(tbc.load_nag_v2(str(src)), jbc.load_nag_v2(str(src)),
                      0)
    ref = jbc.convert_nag_v2_to_v3(str(src), str(tmp_path / 'jax_v3.h5'))
    tbc.main([str(src), '--output-path', str(tmp_path / 'port_v3.h5')])
    got = tmp_path / 'port_v3.h5'
    # each package reads the other's v3 file as its own
    assert_nags_equal(TNAG.load(str(got)), TNAG.load(ref), 0)
    assert_nags_equal(TNAG.load(str(got)), JNAG.load(str(got)), 0)
    assert TNAG.load(str(got)).num_levels == 2
    # the default output path
    assert tbc.convert_nag_v2_to_v3(str(src)) == str(tmp_path /
                                                     'nag_v2_v3.h5')


def test_load_nag_v2_rejects_a_v3_file(tmp_path):
    pytest.importorskip('h5py')
    path = tmp_path / 'v3.h5'
    tsyn.random_nag(seed=0, n_points=200).save(str(path))
    with pytest.raises(ValueError, match='not a v2 NAG'):
        tbc.load_nag_v2(str(path))


def _nags(seed):
    ref, got = jsyn.random_nag(seed=seed, n_points=500), \
        tsyn.random_nag(seed=seed, n_points=500)
    rgb = np.random.default_rng(seed).random(
        (ref[0].num_nodes, 3)).astype(np.float32)
    for nag in (ref, got):
        nag[0]['rgb'] = rgb
        nag[0]['semantic_pred'] = np.asarray(nag[0].y)[::-1].copy()
        nag[0]['x'] = np.asarray(nag[0].linearity).reshape(-1, 1) * rgb
    return ref, got


@pytest.mark.parametrize('kw', [
    dict(max_points=200, num_classes=13),
    dict(max_points=None, voxel=0.5, levels=[0, 1], centroids=False),
], ids=['decimated', 'voxel'])
def test_visualize_3d_html_matches_jax(kw):
    """Byte-equal pages for a NAG and for a Data under one title, every
    color mode embedded."""
    ref_nag, got_nag = _nags(0)
    title = 'room'
    for ref_obj, got_obj in ((ref_nag, got_nag), (ref_nag[0], got_nag[0])):
        ref = jvis.visualize_3d(ref_obj, title=title, **kw).html()
        got = tvis.visualize_3d(got_obj, title=title, **kw).html()
        assert got.encode() == ref.replace(
            '<title>superpoint_transformer_tpu</title>',
            f'<title>{title}</title>').encode()
    assert all(f'"{m}"' in got for m in ('rgb', 'y', 'semantic_pred',
                                          'super_index', 'error', 'x'))


def test_visualize_3d_default_page_is_jaxs(tmp_path):
    """Under the JAX package's default title the pages are byte-equal
    as they stand; the port's default names the port."""
    ref_nag, got_nag = _nags(1)
    ref = jvis.visualize_3d(ref_nag).html()
    title = 'superpoint_transformer_tpu'
    assert tvis.visualize_3d(got_nag, title=title).html() == ref
    fig = tvis.visualize_3d(got_nag)
    assert '<title>superpoint_transformer_torch</title>' in fig.html()
    path = fig.write_html(str(tmp_path / 'a' / 'scene.html'))
    assert open(path).read() == fig.html()


def test_class_palette_and_png_match_jax(tmp_path):
    for n in (1, 13, 40):
        np.testing.assert_array_equal(tvis.class_palette(n),
                                      jvis.class_palette(n))
    pytest.importorskip('matplotlib')
    fig = tvis.visualize_3d(_nags(2)[1], max_points=200)
    fig.to_png(str(tmp_path / 'scene.png'), mode='y')
    assert (tmp_path / 'scene.png').stat().st_size > 1000
