"""Each ported module vs its JAX counterpart on the same numpy inputs
and the same weights (copied with `load_jax_params`): GraphNorm,
unit_sphere_norm, MLP, SelfAttentionBlock, TransformerBlock, pool and
the four stages. JAX runs on the CPU, where the attention block takes
its XLA path; the K2 kernel's own math is pinned by
test_torch_attention_rpe.py."""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from superpoint_transformer_tpu.nn import (
    norm as jnorm, mlp as jmlp, attention as jattn, transformer as jtr,
    stage as jstage)
from superpoint_transformer_tpu.nn.pool import pool as jpool
from superpoint_transformer_torch.nn import (
    norm as tnorm, mlp as tmlp, attention as tattn, transformer as ttr,
    stage as tstage)
from superpoint_transformer_torch.nn.pool import pool as tpool
from superpoint_transformer_torch.utils.jax_params import load_jax_params
from superpoint_transformer_torch.utils.synthetic import random_padded_nag

# f32: the same math in another summation order
RTOL, ATOL = 1e-4, 1e-5
# f32 through a stage (MLP, norms, attention blocks): rounding
# accumulates over the chain on O(1-10) values
TOL_STAGE = (1e-4, 1e-4)
# bf16 Linear/norm chains: both sides round to bf16 (8 mantissa bits) at
# the same points, but f32 sums in another order can flip the last bit
# of a bf16 result, and the flip propagates through the next layers
TOL_BF16 = (3e-2, 3e-2)
# K2 kernel math vs the XLA expression in bf16 (test_torch_attention_rpe.py)
TOL_ATTN_BF16 = (5e-2, 1e-1)


@pytest.fixture(scope='module')
def nag():
    """A small padded batch (2 graphs, K = 16) with numpy leaves."""
    return random_padded_nag(seed=0, num_graphs=2, n_points=600, n_l1=40,
                             n_l2=12, degree=(2, 12))


def _t(a):
    a = np.asarray(a)
    t = torch.from_numpy(a)
    return t.long() if np.issubdtype(a.dtype, np.integer) else t


def _j(a):
    return jnp.asarray(np.asarray(a))


def _init(module, *args, **kw):
    """Random flax params of `module` drawn with numpy (the tree comes
    from `jax.eval_shape`, which only traces): Dense kernels scaled by
    1/sqrt(fan_in), norm scales around 1, biases around 0."""
    shapes = jax.eval_shape(
        lambda: module.init(jax.random.PRNGKey(0), *args, **kw))['params']
    rng = np.random.default_rng(1)

    def draw(path, leaf):
        name = path[-1].key
        r = rng.standard_normal(leaf.shape).astype(np.float32)
        if name == 'kernel':
            return r / np.sqrt(leaf.shape[0])
        return r * 0.1 + (name in ('weight', 'mean_scale'))

    return jax.tree_util.tree_map_with_path(draw, shapes)


def _apply(module, params, *args, **kw):
    """`module.apply` under jit: one XLA compile instead of one per
    eager op."""
    return jax.jit(lambda p: module.apply({'params': p}, *args, **kw))(
        params)


def _port(module, params):
    return load_jax_params(module, params).eval()


def _close(got, ref, valid=None, tol=(RTOL, ATOL)):
    got = got.detach().float().numpy()
    ref = np.asarray(jnp.asarray(ref, jnp.float32))
    if valid is not None:
        got, ref = got[valid], ref[valid]
    np.testing.assert_allclose(got, ref, rtol=tol[0], atol=tol[1])


def _features(nag, level, width, seed=2):
    """Random features on every row, padded rows included, so that a
    statistic that fails to mask them shows."""
    n = nag.levels[level].capacity
    return np.random.default_rng(seed).standard_normal(
        (n, width)).astype(np.float32)


@pytest.mark.parametrize('dtype', ['float32', 'bfloat16'])
def test_graph_norm(nag, dtype):
    lvl = nag.levels[0]
    x = _features(nag, 0, 16)
    jm = jnorm.GraphNorm(16, num_graphs=2)
    args = (_j(x).astype(dtype),)
    kw = dict(batch=_j(lvl.batch), mask=_j(lvl.node_mask))
    params = _init(jm, *args, **kw)
    ref = _apply(jm, params, *args, **kw)
    tm = _port(tnorm.GraphNorm(16, num_graphs=2), params)
    got = tm(_t(x).to(getattr(torch, dtype)), batch=_t(lvl.batch),
             mask=_t(lvl.node_mask))
    assert got.dtype == getattr(torch, dtype)
    _close(got, ref, tol=TOL_BF16 if dtype == 'bfloat16' else (RTOL, ATOL))


@pytest.mark.parametrize('level', [0, 1])
def test_unit_sphere_norm(nag, level):
    """Level 0 into its parents (padded parents are empty segments), and
    level 1 per graph with the padded rows' -1 clipped to graph 0, as the
    innermost stage does."""
    lvl = nag.levels[level]
    if level == 0:
        si, ns = lvl.super_index, nag.levels[1].capacity
    else:
        si, ns = np.clip(lvl.batch, 0, None), 2
    ref_pos, ref_d = jax.jit(
        lambda *a: jnorm.unit_sphere_norm(*a[:2], ns, *a[2:]))(
        _j(lvl.pos), _j(si), _j(lvl.node_size), _j(lvl.node_mask))
    pos, d = tnorm.unit_sphere_norm(
        _t(lvl.pos), _t(si), ns, node_size=_t(lvl.node_size),
        mask=_t(lvl.node_mask))
    _close(pos, ref_pos)
    _close(d, ref_d)


@pytest.mark.parametrize('dtype', [None, 'bfloat16'])
def test_mlp(nag, dtype):
    lvl = nag.levels[0]
    x = _features(nag, 0, 12)
    jm = jmlp.MLP((12, 16, 32), num_graphs=2, compute_dtype=dtype)
    kw = dict(batch=_j(lvl.batch), mask=_j(lvl.node_mask), train=False)
    params = _init(jm, _j(x), **kw)
    ref = _apply(jm, params, _j(x), **kw)
    tm = _port(tmlp.MLP((12, 16, 32), num_graphs=2, compute_dtype=dtype),
               params)
    got = tm(_t(x), batch=_t(lvl.batch), mask=_t(lvl.node_mask))
    assert got.dtype == torch.float32
    _close(got, ref, tol=TOL_BF16 if dtype else (RTOL, ATOL))


def _attention_inputs(nag, level=1, dim=32, de=16):
    lvl = nag.levels[level]
    x = _features(nag, level, dim, seed=3)
    ef = np.random.default_rng(4).standard_normal(
        lvl.edge_feat.shape[:2] + (de,)).astype(np.float32)
    return lvl, x, ef


@pytest.mark.parametrize('dtype', [None, 'bfloat16'])
def test_self_attention_block(nag, dtype):
    """H*D = 16 != C = 32."""
    lvl, x, ef = _attention_inputs(nag)
    cfg = dict(num_heads=4, qk_dim=4, in_rpe_dim=16, k_rpe=True,
               q_rpe=True, v_rpe=True, compute_dtype=dtype)
    jm = jattn.SelfAttentionBlock(dim=32, **cfg)
    args = (_j(x), _j(lvl.nbr_idx), _j(lvl.nbr_mask))
    params = _init(jm, *args, edge_feat=_j(ef), train=False)
    ref = _apply(jm, params, *args, edge_feat=_j(ef),
                   train=False)
    tm = _port(tattn.SelfAttentionBlock(32, **cfg), params)
    got = tm(_t(x), _t(lvl.nbr_idx), _t(lvl.nbr_mask), _t(ef))
    assert got.dtype == torch.float32
    _close(got, ref, tol=TOL_ATTN_BF16 if dtype else (RTOL, ATOL))


@pytest.mark.parametrize('variant', [dict(qk_share_rpe=True),
                                     dict(heads_share_rpe=True),
                                     dict(q_on_minus_rpe=True),
                                     dict(v_rpe=False)])
def test_self_attention_other_rpe_variants_need_k1(nag, variant):
    """The RPE variants other than independent k/q/v run on K1 at
    inference (its plain version on the CPU): the output matches the
    JAX block's."""
    lvl, x, ef = _attention_inputs(nag)
    cfg = dict(num_heads=4, qk_dim=4, in_rpe_dim=16, k_rpe=True,
               q_rpe=True, v_rpe=True)
    cfg.update(variant)
    jm = jattn.SelfAttentionBlock(dim=32, **cfg)
    args = (_j(x), _j(lvl.nbr_idx), _j(lvl.nbr_mask))
    params = _init(jm, *args, edge_feat=_j(ef), train=False)
    ref = _apply(jm, params, *args, edge_feat=_j(ef), train=False)
    tm = _port(tattn.SelfAttentionBlock(32, **cfg), params)
    assert not tm.independent_rpe
    got = tm(_t(x), _t(lvl.nbr_idx), _t(lvl.nbr_mask), _t(ef))
    _close(got, ref)


def test_self_attention_training_needs_k1(nag):
    """Training takes the K1 route (RPE as one matmul added to the
    gathered rows, a query per edge, K1 with its closed-form backward):
    the output and every gradient match the JAX block's train=True
    forward and `jax.grad`. Without edge features the block runs K1 at
    inference too, as in JAX."""
    lvl, x, ef = _attention_inputs(nag)
    cfg = dict(num_heads=4, qk_dim=4, in_rpe_dim=16, k_rpe=True,
               q_rpe=True, v_rpe=True)
    jm = jattn.SelfAttentionBlock(dim=32, **cfg)
    args = (_j(lvl.nbr_idx), _j(lvl.nbr_mask))
    params = _init(jm, _j(x), *args, edge_feat=_j(ef), train=False)
    w = np.random.default_rng(5).standard_normal(x.shape).astype(np.float32)

    def loss(p, xx):
        out = jm.apply({'params': p}, xx, *args, edge_feat=_j(ef),
                       train=True)
        return (out * w).sum(), out

    (_, ref), (gp, gx) = jax.jit(jax.value_and_grad(
        loss, argnums=(0, 1), has_aux=True))(params, _j(x))
    tm = load_jax_params(tattn.SelfAttentionBlock(32, **cfg), params).train()
    tx = _t(x).requires_grad_()
    got = tm(tx, _t(lvl.nbr_idx), _t(lvl.nbr_mask), _t(ef))
    (got * _t(w)).sum().backward()
    _close(got, ref)
    _close(tx.grad, gx)
    grads = {n: p.grad for n, p in tm.named_parameters()}
    for path, g in jax.tree_util.tree_leaves_with_path(gp):
        layer, leaf = path[0].key, path[-1].key
        name = f'{layer}.{"weight" if leaf == "kernel" else "bias"}'
        t = grads[name].t() if leaf == 'kernel' else grads[name]
        _close(t, g, tol=(RTOL, 1e-4))
    # without edge features the block runs K1 at inference too, with a
    # query per node, the RPE modules unused as in JAX
    ref = _apply(jm, params, _j(x), *args, edge_feat=None, train=False)
    _close(tm.eval()(_t(x), _t(lvl.nbr_idx), _t(lvl.nbr_mask), None), ref)


def test_transformer_block_with_ffn(nag):
    lvl, x, ef = _attention_inputs(nag)
    cfg = dict(num_heads=4, qk_dim=4, in_rpe_dim=16, ffn_ratio=2,
               k_rpe=True, q_rpe=True, v_rpe=True, no_ffn=False,
               num_graphs=2)
    jm = jtr.TransformerBlock(32, **cfg)
    kw = dict(nbr_idx=_j(lvl.nbr_idx), nbr_mask=_j(lvl.nbr_mask),
              edge_feat=_j(ef), mask=_j(lvl.node_mask), train=False)
    params = _init(jm, _j(x), _j(lvl.batch), **kw)
    ref = _apply(jm, params, _j(x), _j(lvl.batch), **kw)
    tm = _port(ttr.TransformerBlock(32, **cfg), params)
    got = tm(_t(x), _t(lvl.batch), nbr_idx=_t(lvl.nbr_idx),
             nbr_mask=_t(lvl.nbr_mask), edge_feat=_t(ef),
             mask=_t(lvl.node_mask))
    _close(got, ref, valid=lvl.node_mask)


def test_pool_max_with_empty_parents(nag):
    child, parent = nag.levels[0], nag.levels[1]
    x = _features(nag, 0, 8)
    ref = jpool('max', _j(x), _j(child.super_index), parent.capacity,
                     mask=_j(child.node_mask))
    got = tpool('max', _t(x), _t(child.super_index), parent.capacity,
                     mask=_t(child.node_mask))
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref))
    # padded parents receive no child and come out as 0
    assert np.all(got.numpy()[int(parent.num_nodes):] == 0)


def test_pool_max_gradient_with_ties_and_masked_children(nag):
    """The max-pool backward (scatter_reduce amax) vs JAX's segment_max
    gradient: a tie splits the gradient evenly among the tied children,
    masked children and padded children get none."""
    child, parent = nag.levels[0], nag.levels[1]
    x = np.round(_features(nag, 0, 8) * 2) / 2      # many exact ties
    mask = np.asarray(child.node_mask).copy()
    mask[::7] = False                                # masked valid children
    w = np.random.default_rng(6).standard_normal(
        (parent.capacity, 8)).astype(np.float32)

    def jloss(xx):
        return (jpool('max', xx, _j(child.super_index), parent.capacity,
                      mask=_j(mask)) * w).sum()

    ref = jax.grad(jloss)(_j(x))
    tx = _t(x).requires_grad_()
    (tpool('max', tx, _t(child.super_index), parent.capacity,
           mask=_t(mask)) * _t(w)).sum().backward()
    np.testing.assert_allclose(tx.grad.numpy(), np.asarray(ref), rtol=1e-6,
                               atol=1e-7)
    # some parents' max is tied between children
    out = np.asarray(jpool('max', _j(x), _j(child.super_index),
                           parent.capacity, mask=_j(mask)))
    sup = np.asarray(child.super_index)[mask]
    wins = x[mask] == out[sup]
    ties = np.zeros((parent.capacity + 1, 8), int)
    np.add.at(ties, sup, wins)
    assert ties.max() >= 2
    assert np.all(tx.grad.numpy()[~mask] == 0)


_SHARED = dict(qk_dim=4, in_rpe_dim=16, k_rpe=True, q_rpe=True, v_rpe=True,
               no_ffn=True, use_diameter_parent=True, num_graphs=2)


def _check_stage(jm, tm, jargs, targs, jkw, tkw, valid):
    params = _init(jm, *jargs, **jkw, train=False)
    ref_x, ref_d = _apply(jm, params, *jargs, **jkw, train=False)
    x, d = _port(tm, params)(*targs, **tkw)
    _close(x, ref_x, valid=valid, tol=TOL_STAGE)
    if ref_d is not None:
        _close(d, ref_d)


def test_point_stage(nag):
    l0, l1 = nag.levels[0], nag.levels[1]
    cfg = dict(dim=32, num_blocks=0, in_mlp=(12, 16, 32), **_SHARED)
    x = _features(nag, 0, 8)
    kw = dict(super_index=l0.super_index, num_super=l1.capacity,
              pos=l0.pos, node_size=l0.node_size, mask=l0.node_mask)
    _check_stage(
        jstage.PointStage(**cfg), tstage.PointStage(**cfg),
        (_j(x), _j(l0.batch)), (_t(x), _t(l0.batch)),
        {k: v if k == 'num_super' else _j(v) for k, v in kw.items()},
        {k: v if k == 'num_super' else _t(v) for k, v in kw.items()},
        l0.node_mask)


def test_innermost_stage(nag):
    """Stage with attention at the top level: positions normalized per
    graph, diameter_parent per graph."""
    l2 = nag.levels[2]
    lvl, x, ef = _attention_inputs(nag, level=2, dim=28)
    cfg = dict(dim=32, num_blocks=2, num_heads=4, in_mlp=(32, 32, 32),
               **_SHARED)
    kw = dict(pos=l2.pos, node_size=l2.node_size, nbr_idx=l2.nbr_idx,
              nbr_mask=l2.nbr_mask, edge_feat=ef, mask=l2.node_mask)
    _check_stage(
        jstage.Stage(**cfg), tstage.Stage(**cfg),
        (_j(x), _j(l2.batch)), (_t(x), _t(l2.batch)),
        {k: _j(v) for k, v in kw.items()},
        {k: _t(v) for k, v in kw.items()}, l2.node_mask)


def test_down_and_fuse_stage(nag):
    l0, l1, l2 = nag.levels
    lvl, _, ef = _attention_inputs(nag, level=1)
    x_child = _features(nag, 0, 32)
    cfg = dict(dim=32, num_blocks=2, num_heads=4, in_mlp=(36, 32, 32),
               **_SHARED)
    kw = dict(num_parents=l1.capacity, pos=l1.pos, node_size=l1.node_size,
              super_index=l1.super_index, num_super=l2.capacity,
              nbr_idx=l1.nbr_idx, nbr_mask=l1.nbr_mask, edge_feat=ef,
              child_mask=l0.node_mask, mask=l1.node_mask)
    ints = ('num_parents', 'num_super')
    _check_stage(
        jstage.DownNFuseStage(**cfg), tstage.DownNFuseStage(**cfg),
        (None, _j(x_child), _j(l1.batch), _j(l0.super_index)),
        (None, _t(x_child), _t(l1.batch), _t(l0.super_index)),
        {k: v if k in ints else _j(v) for k, v in kw.items()},
        {k: v if k in ints else _t(v) for k, v in kw.items()},
        l1.node_mask)


def test_up_and_fuse_stage(nag):
    l1, l2 = nag.levels[1], nag.levels[2]
    lvl, x_skip, ef = _attention_inputs(nag, level=1)
    x_parent = _features(nag, 2, 32, seed=5)
    cfg = dict(dim=32, num_blocks=1, num_heads=4, in_mlp=(68, 32, 32),
               **_SHARED)
    kw = dict(pos=l1.pos, node_size=l1.node_size,
              super_index=l1.super_index, num_super=l2.capacity,
              nbr_idx=l1.nbr_idx, nbr_mask=l1.nbr_mask, edge_feat=ef,
              mask=l1.node_mask)
    _check_stage(
        jstage.UpNFuseStage(**cfg), tstage.UpNFuseStage(**cfg),
        (_j(x_skip), _j(x_parent), _j(l1.batch), _j(l1.super_index)),
        (_t(x_skip), _t(x_parent), _t(l1.batch), _t(l1.super_index)),
        {k: v if k == 'num_super' else _j(v) for k, v in kw.items()},
        {k: v if k == 'num_super' else _t(v) for k, v in kw.items()},
        l1.node_mask)
