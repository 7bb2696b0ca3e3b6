"""Stacked whole-cloud serving in the port (`inference.py`:
`strip_for_inference`, `stack_batches`, `infer_nags_stacked`, and
`e2e_inference` on them), on the CPU.

`infer_nags_stacked` must give the per-tile `infer_nag` predictions bit
for bit, whatever the chunk size (the last chunk filled by repeating its
final tile) and with its warm-up. Against the JAX `infer_nags_stacked`
(same tiles, the narrow f32 SPT's weights carried across by
`load_jax_params`) the argmax must agree wherever the JAX logits' top-2
margin exceeds what the f32 forward tolerance lets each side move, the
criterion of `tests/test_torch_host_path.py`'s serving test."""
import dataclasses

import numpy as np
import pytest
import torch

from superpoint_transformer_tpu import inference as jinf
from superpoint_transformer_tpu.models.semantic import (
    SemanticSegmentationModel as JModel)
from superpoint_transformer_tpu.models.spt import SPT as JSPT
from superpoint_transformer_tpu.transforms import prepare as jprep
from superpoint_transformer_tpu.transforms import preprocess as jpre
from superpoint_transformer_tpu.utils import synthetic as jsyn
from superpoint_transformer_torch import inference as tinf
from superpoint_transformer_torch.data.padded import (PaddedNAG, from_numpy,
                                                      strip_for_inference)
from superpoint_transformer_torch.models.semantic import (
    SemanticSegmentationModel as TModel)
from superpoint_transformer_torch.models.spt import SPT as TSPT
from superpoint_transformer_torch.transforms import prepare as tprep
from superpoint_transformer_torch.transforms import preprocess as tpre
from superpoint_transformer_torch.utils import synthetic as tsyn
from superpoint_transformer_torch.utils.jax_params import load_jax_params
from test_torch_host_path import PRE
from test_torch_spt import NARROW, TOL_F32, _params
from test_torch_trainer import one_torch_thread  # noqa: F401

TILES = 4
TILE_POINTS = 5_000


def _pinned(prep, nags, pin):
    """`prep.BatchConfig` for whole-tile evaluation with the capacities
    pinned to the tiles' shared signature by `pin` (each package's own
    copy of what `e2e_inference` does)."""
    cfg = dataclasses.replace(prep.BatchConfig(),
                              **tinf.EVAL_BATCH_OVERRIDES)
    return pin([prep.process_batch([nag], cfg, train=False) for nag in nags],
               cfg)


def _jax_pin(bigs, cfg):
    caps = ({}, {}, {})
    for big in bigs:
        for pinned, sig in zip(caps, jprep.batch_signature(big, cfg)):
            for li, v in sig.items():
                pinned[li] = max(pinned.get(li, 0), v)
    return dataclasses.replace(cfg, node_caps=caps[0],
                               k_caps=caps[1] or None,
                               k_in_caps=caps[2] or None)


@pytest.fixture(scope='module')
def tiles():
    """Four small synthetic rooms preprocessed by each package (the port
    NAGs are bit-equal to JAX's, tests/test_torch_host_path.py), their
    pinned configs, and a narrow f32 SPT in both with the same weights."""
    tnags = [tpre.preprocess_cloud(tsyn.synthetic_room_cloud(
        seed=s, n_points=TILE_POINTS), **PRE) for s in range(TILES)]
    jnags = [jpre.preprocess_cloud(jsyn.synthetic_room_cloud(
        seed=s, n_points=TILE_POINTS), **PRE) for s in range(TILES)]
    tcfg = _pinned(tprep, tnags, tinf.pin_signature)
    jcfg = _pinned(jprep, jnags, _jax_pin)
    assert (tcfg.node_caps, tcfg.k_caps, tcfg.k_in_caps) == (
        jcfg.node_caps, jcfg.k_caps, jcfg.k_in_caps)
    jm = JModel(net=JSPT(compute_dtype=None, **NARROW), num_classes=13)
    shapes = jprep.prepare_batch([jnags[0]], jcfg, train=False,
                                 device=False)
    variables = {'params': _params(jm, shapes)}
    tm = TModel(TSPT(compute_dtype=None, **NARROW), 13)
    load_jax_params(tm, variables['params']).eval()
    return tnags, jnags, tcfg, jcfg, tm, jm, variables


@pytest.fixture(scope='module')
def loop(tiles):
    tnags, _, tcfg, _, tm, _, _ = tiles
    return [tinf.infer_nag(tm, nag, tcfg) for nag in tnags]


@pytest.mark.parametrize('max_tiles', [1, 3, 8])
def test_stacked_equals_the_per_tile_loop(tiles, loop, max_tiles):
    """Bit for bit, for chunks of 1, of 3 (4 tiles: the second chunk
    filled with its last tile twice more) and of all 4 tiles."""
    tnags, _, tcfg, _, tm, _, _ = tiles
    timings = {}
    got = tinf.infer_nags_stacked(tm, tnags, tcfg, timings=timings,
                                  max_tiles_per_program=max_tiles)
    assert len(got) == TILES
    for g, ref, nag in zip(got, loop, tnags):
        assert g.dtype == np.int32 and g.shape == (nag[1].num_nodes,)
        np.testing.assert_array_equal(g, ref)
    assert set(timings) == {'pad', 'transfer', 'forward', 'fetch'}


def test_stacked_warmup_returns_the_same_predictions(tiles, loop):
    tnags, _, tcfg, _, tm, _, _ = tiles
    timings = {}
    got = tinf.infer_nags_stacked(tm, tnags, tcfg, timings=timings,
                                  warmup=True, max_tiles_per_program=3)
    for g, ref in zip(got, loop):
        np.testing.assert_array_equal(g, ref)
    assert set(timings) == {'pad', 'transfer', 'forward', 'fetch',
                            'warmup_compile'}
    assert all(v >= 0 for v in timings.values())


def test_stacked_from_processed_tiles(tiles, loop):
    """`processed` (transform-complete NAGs) pads without re-running the
    transforms, to the same predictions."""
    tnags, _, tcfg, _, tm, _, _ = tiles
    bigs = [tprep.process_batch([nag], tcfg, train=False) for nag in tnags]
    got = tinf.infer_nags_stacked(tm, tnags, tcfg, processed=bigs)
    for g, ref in zip(got, loop):
        np.testing.assert_array_equal(g, ref)


def test_stacked_agrees_with_jax(tiles):
    tnags, jnags, tcfg, jcfg, tm, jm, variables = tiles
    got = tinf.infer_nags_stacked(tm, tnags, tcfg, max_tiles_per_program=3)
    ref = jinf.infer_nags_stacked(jm, variables, jnags, jcfg,
                                  max_tiles_per_program=3)
    sure_all = []
    for g, r, jnag in zip(got, ref, jnags):
        logits = jinf.infer_nag(jm, variables, jnag, jcfg, fetch='logits')
        np.testing.assert_array_equal(r, logits.argmax(1))
        top2 = np.sort(logits, axis=1)[:, -2:]
        slack = 2 * (TOL_F32['atol'] + TOL_F32['rtol'] * np.abs(top2[:, 1]))
        sure = (top2[:, 1] - top2[:, 0]) / slack > 1
        np.testing.assert_array_equal(g[sure], r[sure])
        sure_all.append(sure)
    assert np.concatenate(sure_all).mean() > 0.9


def test_e2e_inference_runs_the_stacked_forward(tiles, monkeypatch):
    """`e2e_inference` serves its tiles through `infer_nags_stacked` with
    the transform-complete NAGs, and labels every raw point."""
    _, _, _, _, tm, _, _ = tiles
    calls = []
    stacked = tinf.infer_nags_stacked

    def spy(*args, **kw):
        calls.append(kw)
        return stacked(*args, **kw)

    monkeypatch.setattr(tinf, 'infer_nags_stacked', spy)
    raw = tsyn.synthetic_room_cloud(seed=7, n_points=8_000)
    pred, info = tinf.e2e_inference(tm, raw, pre_cfg=PRE, tiling=(2, 2))
    assert len(calls) == 1 and calls[0]['processed'] is not None
    assert calls[0]['warmup'] is True
    assert info['n_tiles'] == 4 and pred.shape == (raw.num_nodes,)
    assert pred.min() >= 0 and pred.max() < 13
    assert {'pad', 'transfer', 'forward', 'fetch', 'warmup_compile'} <= set(
        info['timings_sec'])


def _host_batch(nag, cfg):
    return tinf._pad_eval(tprep.process_batch([nag], cfg, train=False), cfg)


def test_strip_for_inference_drops_the_training_fields(tiles):
    tnags, _, tcfg, _, _, _, _ = tiles
    host = tprep.prepare_batch([tnags[0]], tcfg, train=True,
                               rng=np.random.default_rng(0))
    assert host[1].y is not None and host[1].nbr_in_idx is not None
    assert host[1].node_id is not None
    out = strip_for_inference(host)
    assert isinstance(out, PaddedNAG)
    for lvl, src in zip(out.levels, host.levels):
        for f in dataclasses.fields(lvl):
            v = getattr(lvl, f.name)
            if f.name in ('y', 'nbr_in_idx', 'nbr_in_mask', 'node_id'):
                assert v is None, f.name
            else:
                assert v is getattr(src, f.name), f.name
    # from_numpy(train=False) is the strip plus the transfer
    a = from_numpy(host, 'cpu')
    b = from_numpy(out, 'cpu')
    assert a.level1_node_id is not None and b.level1_node_id is None
    for la, lb in zip(a.levels, b.levels):
        for f in dataclasses.fields(la):
            va, vb = getattr(la, f.name), getattr(lb, f.name)
            assert (va is None) == (vb is None), f.name
            if torch.is_tensor(va):
                assert torch.equal(va, vb), f.name


def test_stack_batches_stacks_leaves_and_keeps_node_counts(tiles):
    tnags, _, tcfg, _, _, _, _ = tiles
    hosts = [strip_for_inference(_host_batch(n, tcfg)) for n in tnags[:3]]
    st = tinf.stack_batches(hosts)
    for li, lvl in enumerate(st.levels):
        assert lvl.num_nodes == tuple(h.levels[li].num_nodes for h in hosts)
        assert lvl.pos.shape == (3,) + hosts[0].levels[li].pos.shape
        np.testing.assert_array_equal(lvl.pos[1], hosts[1].levels[li].pos)
    dev = from_numpy(st, 'cpu')
    tile = tinf._tile(dev, 2)
    assert tile[1].num_nodes == hosts[2][1].num_nodes
    assert tile[1].nbr_idx.is_contiguous()
    assert torch.equal(tile[1].nbr_idx,
                       torch.from_numpy(hosts[2][1].nbr_idx).long())


def test_stack_batches_raises_on_another_signature(tiles):
    tnags, _, tcfg, _, _, _, _ = tiles
    a = strip_for_inference(_host_batch(tnags[0], tcfg))
    wide = dataclasses.replace(
        tcfg, node_caps={li: 2 * c for li, c in tcfg.node_caps.items()})
    b = strip_for_inference(_host_batch(tnags[0], wide))
    with pytest.raises(ValueError, match='shapes differ'):
        tinf.stack_batches([a, b])
