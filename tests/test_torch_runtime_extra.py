"""The last public functions of the JAX package against their copies in
the port, on the CPU: the long-tail runtime transforms (k-hop crops,
outliers and inliers, feature dropout, shuffle, key and column
selection), multi-run TTA accumulation, `SemanticTask.predict`, the 1-D
label confusion update, and the small exports (`segment_csr_arange`,
`largest_eig3_np`, `untrim_edges_np`, `native_available`,
`UnitSphereNorm`, `INDEX_BASED_NORMS`, `SPT.num_up_stages`,
`save_confusion_matrix_png`), and the attention block's `fused_rpe=False`
and `fuse_rpe_matmul=False` inference routes.

The same NAG (`random_nag` of one seed, equal in both packages) and the
same `np.random.default_rng(seed)` go to both sides. The host functions
are copies of the same numpy code over the same native sources, so the
NAGs must be bit-equal; the float64 TTA sums are held to 1e-12.

On the CPU the JAX block takes its materialized XLA route whatever its
switches say (the Pallas kernels need a non-CPU backend), so the
`fused_rpe=False` route of the port, whose K1 wrapper runs its plain
version on CPU tensors, is held to that forward; K1 itself is held to
its plain version on the card by `chip_smoke.py`."""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from superpoint_transformer_tpu.metrics import semantic as jmet
from superpoint_transformer_tpu.models import output as jout
from superpoint_transformer_tpu.models.semantic import (
    SemanticSegmentationModel as JModel, SemanticTask as JTask, TrainState)
from superpoint_transformer_tpu.models.spt import SPT as JSPT
from superpoint_transformer_tpu.nn import attention as jattn
from superpoint_transformer_tpu.nn import norm as jnorm
from superpoint_transformer_tpu.ops import graph as jgraph
from superpoint_transformer_tpu.ops import segment as jseg
from superpoint_transformer_tpu.ops import subedges as jsub
from superpoint_transformer_tpu.optim.lr_scheduler import make_optimizer
from superpoint_transformer_tpu.transforms import BatchConfig, prepare_batch
from superpoint_transformer_tpu.transforms import runtime as JT
from superpoint_transformer_tpu.utils import synthetic as jsyn
from superpoint_transformer_tpu.utils import wandb as jwandb
from superpoint_transformer_torch.data.padded import from_numpy
from superpoint_transformer_torch.metrics import semantic as tmet
from superpoint_transformer_torch.models import output as tout
from superpoint_transformer_torch.models.semantic import (
    SemanticSegmentationModel as TModel, SemanticTask)
from superpoint_transformer_torch.models.spt import SPT as TSPT
from superpoint_transformer_torch.nn import attention as tattn
from superpoint_transformer_torch.nn import norm as tnorm
from superpoint_transformer_torch.ops import graph as tgraph
from superpoint_transformer_torch.ops import native as tnative
from superpoint_transformer_torch.ops import segment as tseg
from superpoint_transformer_torch.ops import subedges as tsub
from superpoint_transformer_torch.transforms import runtime as TT
from superpoint_transformer_torch.utils import synthetic as tsyn
from superpoint_transformer_torch.utils import wandb as twandb
from superpoint_transformer_torch.utils.jax_params import load_jax_params
from test_torch_host_path import assert_nags_equal
from test_torch_spt import NARROW, TOL_F32, _params

TTA_ATOL = 1e-12


def _pair(seed, n_points=512):
    return (jsyn.random_nag(seed=seed, n_points=n_points),
            tsyn.random_nag(seed=seed, n_points=n_points))


def _both(fn_name, seed, *args, rng_seed=None, prepare=None, **kwargs):
    """Run the transform `fn_name` of each package on its copy of the
    same NAG (after `prepare(nag)`), with a fresh `default_rng(rng_seed)`
    each when given; returns (JAX result, port result)."""
    out = []
    for mod, nag in zip((JT, TT), _pair(seed)):
        if prepare is not None:
            prepare(nag)
        rng = () if rng_seed is None else (np.random.default_rng(rng_seed),)
        out.append(getattr(mod, fn_name)(nag, *rng, *args, **kwargs))
    return out


@pytest.mark.parametrize('k_hop, n_seeds, i_level', [
    (1, 2, 1), (2, 4, 1), (2, 16, 1), (1, 3, 2)])
def test_sample_khop_subgraphs_matches_jax(k_hop, n_seeds, i_level):
    ref, got = _both('sample_khop_subgraphs', 0, rng_seed=3, k_hop=k_hop,
                     n_seeds=n_seeds, i_level=i_level)
    assert 0 < got[i_level].num_nodes <= 64
    assert_nags_equal(got, ref, 0)


def _neighbors(nag):
    """A level-0 `neighbor_index` with -1 padding, 0-5 valid a row."""
    n = nag[0].num_nodes
    rng = np.random.default_rng(7)
    nbr = rng.integers(0, n, size=(n, 5))
    nbr[np.arange(5)[None, :] >= rng.integers(0, 6, n)[:, None]] = -1
    nag[0]['neighbor_index'] = nbr


@pytest.mark.parametrize('k_min', [0, 1, 3, 5])
def test_outliers_matches_jax(k_min):
    ref, got = _both('outliers', 1, prepare=_neighbors, k_min=k_min)
    n = got[0].num_nodes
    assert (0 < n < 512) if k_min else (n == 512)
    assert_nags_equal(got, ref, 0)


@pytest.mark.parametrize('recursive', [False, True],
                         ids=['once', 'recursive'])
def test_inliers_matches_jax(recursive):
    ref, got = _both('inliers', 2, k_min=3, r_max=2.0,
                     recursive=recursive)
    assert 0 < got[0].num_nodes < 512
    assert_nags_equal(got, ref, 0)


@pytest.mark.parametrize('fn', ['dropout_columns', 'dropout_rows'])
@pytest.mark.parametrize('key, level', [('rgb', 0), ('normal', 'all'),
                                        ('normal', '1+')])
def test_feature_dropout_matches_jax(fn, key, level):
    ref, got = _both(fn, 3, rng_seed=5, key=key, p=0.4, level=level)
    assert_nags_equal(got, ref, 0)


@pytest.mark.parametrize('level', [0, 1, 2])
def test_shuffle_matches_jax(level):
    ref, got = _both('shuffle', 4, rng_seed=level, level=level)
    assert_nags_equal(got, ref, 0)


def _is_val(nag):
    nag[1]['is_val'] = np.random.default_rng(11).random(
        nag[1].num_nodes) < 0.5


@pytest.mark.parametrize('negation', [False, True], ids=['val', 'train'])
@pytest.mark.parametrize('delete_after', [True, False])
def test_select_by_key_matches_jax(negation, delete_after):
    ref, got = _both('select_by_key', 5, 'is_val', prepare=_is_val, level=1,
                     negation=negation, delete_after=delete_after)
    assert ('is_val' in got[1].keys()) != delete_after
    assert 0 < got[1].num_nodes < 64
    assert_nags_equal(got, ref, 0)


@pytest.mark.parametrize('value, error', [
    (None, 'no `is_val`'), (np.zeros(64, np.int64), 'dtype'),
    (np.zeros(63, bool), 'shape')], ids=['missing', 'dtype', 'shape'])
def test_select_by_key_strictness_as_jax(value, error):
    for mod, nag in zip((JT, TT), _pair(5)):
        if value is not None:
            nag[1]['is_val'] = value
        with pytest.raises(ValueError, match=error):
            mod.select_by_key(nag, 'is_val', level=1)
        same = mod.select_by_key(nag, 'is_val', level=1, strict=False)
        assert same is nag


@pytest.mark.parametrize('key, idx, level', [
    ('normal', [2, 0], 'all'), ('rgb', [1], 0), ('y', None, 'all'),
    ('edge_attr', np.arange(3), '1+')])
def test_select_columns_matches_jax(key, idx, level):
    ref, got = _both('select_columns', 6, key, idx, level=level)
    assert_nags_equal(got, ref, 0)


def _tta_runs(seed, num_nodes, num_classes, n_runs, cover):
    """Per run: f32 logits and `cover` distinct node ids of [0, n)."""
    rng = np.random.default_rng(seed)
    ids = [rng.choice(num_nodes, cover, replace=False)
           for _ in range(n_runs)]
    logits = [rng.standard_normal((cover, num_classes)).astype(np.float32)
              for _ in range(n_runs)]
    return logits, ids


@pytest.mark.parametrize('cover, with_pos', [(60, True), (25, True),
                                             (25, False)],
                         ids=['all-seen', 'unseen', 'unseen-no-pos'])
def test_tta_accumulate_matches_jax(cover, with_pos):
    n, c = 64, 13
    logits, ids = _tta_runs(0, n, c, 3, cover)
    pos = (np.random.default_rng(1).random((n, 3)).astype(np.float32)
           if with_pos else None)
    ref = jout.tta_accumulate(logits, ids, n, c, pos=pos)
    got = tout.tta_accumulate(logits, ids, n, c, pos=pos)
    assert got.dtype == np.float64 and got.shape == (n, c)
    np.testing.assert_allclose(got, ref, rtol=0, atol=TTA_ATOL)
    seen = np.zeros(n, bool)
    for i in ids:
        seen[i] = True
    if cover == 25:
        assert not seen.all()
        assert (np.abs(got[~seen]).sum(1) > 0).all() == with_pos


@pytest.mark.parametrize('logits', [False, True], ids=['ids', 'logits'])
@pytest.mark.parametrize('masked', [False, True], ids=['all', 'masked'])
def test_confusion_matrix_update_matches_jax(logits, masked):
    n, c = 300, 13
    rng = np.random.default_rng(2)
    y = rng.integers(-2, c + 3, n)          # void labels on both sides
    pred = (rng.standard_normal((n, c)).astype(np.float32) if logits
            else rng.integers(0, c, n))
    mask = rng.random(n) < 0.7 if masked else None
    ref = np.asarray(jmet.confusion_matrix_update(
        jnp.asarray(pred), jnp.asarray(y), c,
        node_mask=None if mask is None else jnp.asarray(mask)))
    got = tmet.confusion_matrix_update(
        torch.from_numpy(pred), torch.from_numpy(y), c,
        node_mask=None if mask is None else torch.from_numpy(mask))
    assert got.dtype == torch.int64 and got.shape == (c, c)
    np.testing.assert_array_equal(got.numpy(), ref)
    valid = (y >= 0) & (y < c) & (True if mask is None else mask)
    assert got.sum().item() == valid.sum()


def test_confusion_matrix_update_equals_the_histogram_update():
    n, c = 200, 13
    rng = np.random.default_rng(3)
    y = torch.from_numpy(rng.integers(0, c + 1, n))
    pred = torch.from_numpy(rng.integers(0, c, n))
    mask = torch.from_numpy(rng.random(n) < 0.8)
    hist = torch.nn.functional.one_hot(y, c + 1)
    assert torch.equal(
        tmet.confusion_matrix_update(pred, y, c, node_mask=mask),
        tmet.confusion_matrix_from_histogram(pred, hist, c, node_mask=mask))


@pytest.fixture(scope='module')
def narrow_batch():
    """A 2-graph batch of the JAX host path with label histograms."""
    nags = [jsyn.random_nag(seed=0), jsyn.random_nag(seed=1)]
    cfg = BatchConfig(sample_graph_r=-1, sample_segment_ratio=0)
    return prepare_batch(nags, cfg, train=False, device=False)


def test_predict_matches_jax(narrow_batch):
    """`SemanticTask.predict` on the narrow SPT with JAX's weights: the
    same argmax over every row of level 1, on the model's device."""
    jtask = JTask(net=JSPT(**NARROW), num_classes=13)
    params = _params(jtask.model, narrow_batch)
    state = TrainState.create(
        apply_fn=jtask.model.apply, params=params,
        tx=make_optimizer(lr=0.01, params=params))
    ref = np.asarray(jtask.predict(state, narrow_batch))
    task = SemanticTask(TSPT(**NARROW), num_classes=13)
    load_jax_params(task.model, params)
    got = task.predict(from_numpy(narrow_batch, 'cpu', train=True))
    assert got.device.type == 'cpu' and got.dtype == torch.int64
    n1 = int(narrow_batch.levels[1].num_nodes)
    np.testing.assert_array_equal(got.numpy()[:n1], ref[:n1])


@pytest.mark.parametrize('fuse_rpe_matmul', [True, False],
                         ids=['one-matmul', 'three-matmuls'])
def test_unfused_rpe_inference_route_matches_jax(narrow_batch, monkeypatch,
                                                 fuse_rpe_matmul):
    """The flagship RPE served materialized on K1's forward
    (`set_pallas_attention(model, True, fused_rpe=False, ...)`): every
    block takes that route (no K2 call) and the logits are JAX's under
    the same switches, within TOL_F32."""
    jm = JModel(net=JSPT(**NARROW), num_classes=13)
    params = _params(jm, narrow_batch)
    try:
        jattn.set_pallas_attention(True, fused_rpe=False,
                                   fuse_rpe_matmul=fuse_rpe_matmul)
        ref = jax.jit(lambda p, b: jm.apply({'params': p}, b, train=False))(
            params, narrow_batch)
        ref = [np.asarray(r) for r in ref]
    finally:
        jattn.set_pallas_attention(True, fused_rpe=True,
                                   fuse_rpe_matmul=True)
    tm = load_jax_params(TModel(TSPT(**NARROW), 13), params).eval()
    assert tattn.set_pallas_attention(
        tm, True, fused_rpe=False, fuse_rpe_matmul=fuse_rpe_matmul) is tm
    calls = {'K1': 0, 'K2': 0, 'matmuls': 0}

    def counting(name, fn):
        def wrapped(*args):
            calls[name] += 1
            return fn(*args)
        return wrapped

    monkeypatch.setattr(tattn, 'dense_attention',
                        counting('K1', tattn.dense_attention))
    monkeypatch.setattr(tattn, 'dense_attention_rpe',
                        counting('K2', tattn.dense_attention_rpe))
    blocks = [m for m in tm.modules()
              if isinstance(m, tattn.SelfAttentionBlock)]
    flat = tattn.SelfAttentionBlock._flagship_terms
    monkeypatch.setattr(tattn.SelfAttentionBlock, '_flagship_terms',
                        lambda self, *a: (calls.__setitem__(
                            'matmuls', calls['matmuls'] + 1),
                            flat(self, *a))[1])
    with torch.inference_mode():
        got = tm(from_numpy(narrow_batch, 'cpu'))
    assert calls == {'K1': len(blocks), 'K2': 0,
                     'matmuls': len(blocks) * fuse_rpe_matmul}
    for lvl, g, r in zip(narrow_batch.levels[1:], got, ref):
        valid = np.asarray(lvl.node_mask)
        np.testing.assert_allclose(g.numpy()[valid], r[valid], **TOL_F32)


def test_set_pallas_attention_flag_runs_the_plain_attention(narrow_batch):
    """`flag=False` is `plain_attention`, and switches left None stay."""
    tm = TModel(TSPT(**NARROW), 13)
    tattn.set_pallas_attention(tm, True, fused_rpe=False)
    tattn.set_pallas_attention(tm, False)
    blocks = [m for m in tm.modules()
              if isinstance(m, tattn.SelfAttentionBlock)]
    assert blocks and all(b.plain_attention and not b.fused_rpe
                          and b.fuse_rpe_matmul for b in blocks)
    assert all(b.fused_rpe for b in TModel(TSPT(**NARROW), 13).modules()
               if isinstance(b, tattn.SelfAttentionBlock))


def test_segment_csr_arange_matches_jax():
    ptr = np.array([0, 3, 3, 7, 10], np.int64)
    for total in (10, 12):
        ref = [np.asarray(a) for a in jseg.segment_csr_arange(
            jnp.asarray(ptr, jnp.int32), total)]
        got = [a.numpy() for a in tseg.segment_csr_arange(
            torch.from_numpy(ptr), total)]
        for g, r in zip(got, ref):
            np.testing.assert_array_equal(g, r)
    np.testing.assert_array_equal(got[0][:10],
                                  [0, 1, 2, 0, 1, 2, 3, 0, 1, 2])


def test_largest_eig3_np_matches_jax():
    rng = np.random.default_rng(4)
    a = rng.standard_normal((200, 3, 4))
    cov = a @ a.transpose(0, 2, 1)
    cov[0] = 0                                   # degenerate
    cov[1] = np.eye(3)                           # triple eigenvalue
    cov[2] = np.diag([2.0, 1.0, 1.0])            # double eigenvalue
    got = tsub.largest_eig3_np(cov)
    np.testing.assert_allclose(got, jsub.largest_eig3_np(cov), rtol=0,
                               atol=1e-6)
    lam = np.linalg.eigvalsh(cov)[:, -1]
    np.testing.assert_allclose(np.einsum('eij,ej->ei', cov[3:], got[3:]),
                               lam[3:, None] * got[3:], atol=1e-6)
    np.testing.assert_array_equal(got[:3], np.eye(3)[[0, 0, 0]])


def test_untrim_edges_np_matches_jax():
    ei = np.array([[0, 1, 2], [1, 3, 3]])
    ea = np.arange(6, dtype=np.float32).reshape(3, 2)
    for attr in (ea, None):
        ref = jgraph.untrim_edges_np(ei, attr)
        got = tgraph.untrim_edges_np(ei, attr)
        np.testing.assert_array_equal(got[0], ref[0])
        assert (got[1] is None) == (attr is None)
        if attr is not None:
            np.testing.assert_array_equal(got[1], ref[1])


def test_native_available_builds_nothing(monkeypatch, tmp_path):
    """True once the host library is built and loads; False for a build
    directory without it, where nothing is built; a stale-free library
    that does not load raises."""
    tnative.build()
    assert tnative.native_available()
    monkeypatch.setattr(tnative, '_BUILD_DIR', tmp_path)
    assert not tnative.native_available()
    assert list(tmp_path.iterdir()) == []
    (tmp_path / 'libspt_native.so').write_bytes(b'not a library')
    tnative.library.cache_clear()
    try:
        with pytest.raises(OSError):
            tnative.native_available()
    finally:
        monkeypatch.undo()
        tnative.library.cache_clear()
    assert tnative.native_available()


@pytest.mark.parametrize('log_diameter', [False, True])
def test_unit_sphere_norm_module_matches_jax(log_diameter):
    rng = np.random.default_rng(5)
    pos = rng.random((40, 3)).astype(np.float32) * 4
    si = np.sort(rng.integers(0, 6, 40))
    size = rng.integers(1, 5, 40).astype(np.float32)
    mask = rng.random(40) < 0.9
    ref = jnorm.UnitSphereNorm(log_diameter=log_diameter).apply(
        {}, jnp.asarray(pos), jnp.asarray(si), 6,
        node_size=jnp.asarray(size), mask=jnp.asarray(mask))
    t = [torch.from_numpy(a) for a in (pos, si, size, mask)]
    got = tnorm.UnitSphereNorm(log_diameter=log_diameter)(
        t[0], t[1], 6, node_size=t[2], mask=t[3])
    fn = tnorm.unit_sphere_norm(t[0], t[1], 6, node_size=t[2], mask=t[3])
    assert torch.equal(got[0], fn[0])
    assert torch.equal(got[1], torch.log(fn[1] + 1) if log_diameter
                       else fn[1])
    for g, r in zip(got, ref):
        np.testing.assert_allclose(g.numpy(), np.asarray(r), rtol=1e-6,
                                   atol=1e-6)


def test_index_based_norms_and_up_stages_as_jax():
    assert [c.__name__ for c in tnorm.INDEX_BASED_NORMS] == \
        [c.__name__ for c in jnorm.INDEX_BASED_NORMS]
    assert TSPT(**NARROW).num_up_stages == JSPT(**NARROW).num_up_stages == 1
    assert TSPT(**dict(NARROW, up_dim=(), up_in_mlp=())).num_up_stages == 0


def test_save_confusion_matrix_png_as_jax(tmp_path):
    import matplotlib.image as mpimg
    cm = np.random.default_rng(6).integers(0, 50, (5, 5))
    names = [f'c{i}' for i in range(5)]
    ref = jwandb.save_confusion_matrix_png(cm, str(tmp_path / 'j/cm.png'),
                                           class_names=names)
    got = twandb.save_confusion_matrix_png(cm, str(tmp_path / 't/cm.png'),
                                           class_names=names)
    assert got == str(tmp_path / 't/cm.png')
    np.testing.assert_array_equal(mpimg.imread(got), mpimg.imread(ref))
