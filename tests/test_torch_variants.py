"""The options of the SPT that no config sets, each held to the JAX
package on the CPU: the norms (layer, instance, group, batch), the pools
(min, mean, sum, std, attentive), the fusions, the MLP norms and
dropout, the attention's RPE variants and qk scales, post-norm blocks,
DropPath and the dropouts, three narrow SPTs that turn them on together
(served, and one train step), and the LR schedules.

The same numpy inputs and the same weights (`load_jax_params`, the
running statistics of BatchNorm included) go through both packages; JAX
takes its XLA attention path on the CPU, the port K1's and K2's plain
versions. Tolerances: 1e-5 for a module in f32; the narrow SPTs' logits
1e-4 (test_torch_spt.py's f32 tolerance) and a step's loss and gradients
at test_torch_train.py's (1e-4 relative, each gradient to its largest
entry). Dropout cannot draw JAX's bits: at rate 0 in training and at
any rate in evaluation the outputs match; in training at rate > 0 the
masks' statistics are held (the kept share within 3 sigma of 1 - p, the
kept values scaled by 1 / (1 - p)), and a reseeded stream repeats its
masks."""
import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from superpoint_transformer_tpu.models.semantic import (
    SemanticSegmentationModel as JModel, SemanticTask as JTask)
from superpoint_transformer_tpu.models.spt import SPT as JSPT
from superpoint_transformer_tpu.nn import (
    attention as jattn, mlp as jmlp, norm as jnorm, stage as jstage,
    transformer as jtr)
from superpoint_transformer_tpu.nn.pool import (
    AttentivePool as JAttentivePool, pool as jpool)
from superpoint_transformer_tpu.optim import lr_scheduler as jlr
from superpoint_transformer_tpu.transforms import BatchConfig, prepare_batch
from superpoint_transformer_tpu.utils.synthetic import random_nag
from superpoint_transformer_torch.data.padded import from_numpy
from superpoint_transformer_torch.models.semantic import SemanticTask
from superpoint_transformer_torch.models.spt import SPT as TSPT
from superpoint_transformer_torch.nn import (
    attention as tattn, dropout as tdrop, mlp as tmlp, norm as tnorm,
    stage as tstage, transformer as ttr)
from superpoint_transformer_torch.nn.pool import (
    AttentivePool as TAttentivePool, pool as tpool)
from superpoint_transformer_torch.optim import lr_scheduler as tlr
from superpoint_transformer_torch.utils.jax_params import (jax_key_for,
                                                           load_jax_params)
from superpoint_transformer_torch.utils.synthetic import random_padded_nag

TOL = dict(rtol=1e-5, atol=1e-5)
TOL_SPT = dict(rtol=1e-4, atol=1e-4)
TOL_LOSS, TOL_GRAD = 1e-4, 1e-4


@pytest.fixture(scope='module')
def nag():
    """2 graphs: level 0 over 1024 rows (the norms' one-hot route),
    level 1 under (their sorted route)."""
    return random_padded_nag(seed=0, num_graphs=2, n_points=1400, n_l1=60,
                             n_l2=12, degree=(2, 12))


def _t(a):
    a = np.asarray(a)
    t = torch.from_numpy(np.ascontiguousarray(a))
    return t.long() if np.issubdtype(a.dtype, np.integer) else t


def _j(a):
    return jnp.asarray(np.asarray(a))


def _draw(shapes, seed=1):
    """Random flax variables over an `eval_shape` tree: kernels scaled by
    1/sqrt(fan_in), norm scales around 1, biases and learnt queries
    around 0, running variances positive."""
    rng = np.random.default_rng(seed)

    def draw(path, leaf):
        name = path[-1].key
        r = rng.standard_normal(leaf.shape).astype(np.float32)
        if name == 'kernel':
            return r / np.float32(np.sqrt(leaf.shape[0]))
        if name == 'var':
            return np.abs(r) + np.float32(0.5)
        return r * np.float32(0.1) + np.float32(
            name in ('weight', 'mean_scale'))

    return jax.tree_util.tree_map_with_path(draw, shapes)


def _variables(module, *args, **kw):
    return _draw(jax.eval_shape(
        lambda: module.init(jax.random.PRNGKey(0), *args, **kw)))


def _apply(module, variables, *args, mutable=False, **kw):
    return jax.jit(lambda v: module.apply(v, *args, mutable=mutable,
                                          **kw))(variables)


def _port(module, variables):
    return load_jax_params(module, variables['params'],
                           variables.get('batch_stats'))


def _close(got, ref, tol=TOL, valid=None):
    got = got.detach().float().numpy()
    ref = np.asarray(ref, np.float32)
    if valid is not None:
        got, ref = got[valid], ref[valid]
    np.testing.assert_allclose(got, ref, **tol)


def _features(n, width, seed=2):
    return np.random.default_rng(seed).standard_normal(
        (n, width)).astype(np.float32)


# ---- norms ------------------------------------------------------------

NORMS = {'layer': (jnorm.LayerNorm, tnorm.LayerNorm),
         'instance': (jnorm.InstanceNorm, tnorm.InstanceNorm),
         'group': (jnorm.GroupNorm, tnorm.GroupNorm)}


@pytest.mark.parametrize('level', [0, 1])
@pytest.mark.parametrize('kind', sorted(NORMS))
def test_index_norms_match_jax(nag, kind, level):
    lvl = nag.levels[level]
    x = _features(lvl.capacity, 16)
    jcls, tcls = NORMS[kind]
    jm = jcls(16, num_graphs=2)
    kw = dict(batch=_j(lvl.batch), mask=_j(lvl.node_mask))
    v = _variables(jm, _j(x), **kw)
    ref = _apply(jm, v, _j(x), **kw)
    got = _port(tcls(16, num_graphs=2), v)(
        _t(x), batch=_t(lvl.batch), mask=_t(lvl.node_mask))
    _close(got, ref)


def test_layer_norm_node_mode_matches_jax(nag):
    x = _features(50, 8)
    jm = jnorm.LayerNorm(8, mode='node')
    v = _variables(jm, _j(x))
    _close(_port(tnorm.LayerNorm(8, mode='node'), v)(_t(x)),
           _apply(jm, v, _j(x)))


@pytest.mark.parametrize('masked', [False, True])
def test_batch_norm_matches_jax(nag, masked):
    """Training: the masked batch statistics and the running ones moved
    by JAX's momentum over the masked count; evaluation: the running
    statistics."""
    lvl = nag.levels[0]
    x = _features(lvl.capacity, 16)
    mask = _j(lvl.node_mask) if masked else None
    jm = jnorm.BatchNorm(16)
    v = _variables(jm, _j(x), mask=mask, train=False)
    ref, upd = _apply(jm, v, _j(x), mask=mask, train=True,
                      mutable=['batch_stats'])
    tm = _port(tnorm.BatchNorm(16), v).train()
    got = tm(_t(x), mask=_t(lvl.node_mask) if masked else None)
    _close(got, ref)
    _close(tm.mean, upd['batch_stats']['mean'])
    _close(tm.var, upd['batch_stats']['var'])
    tm.eval()
    _close(tm(_t(x)), _apply(jm, {**v, **upd}, _j(x), train=False))


# ---- MLP: the norms and the dropout -------------------------------------

@pytest.mark.parametrize('norm', [None, 'layer', 'instance', 'group',
                                  'batch'])
def test_mlp_norms_match_jax(nag, norm):
    """Without a norm the Linear layers take a bias; the dropout rate is
    the identity in evaluation."""
    lvl = nag.levels[0]
    x = _features(lvl.capacity, 12)
    jm = jmlp.MLP((12, 16, 32), norm=norm, drop=0.3, num_graphs=2)
    kw = dict(batch=_j(lvl.batch), mask=_j(lvl.node_mask), train=False)
    v = _variables(jm, _j(x), **kw)
    tm = _port(tmlp.MLP((12, 16, 32), norm=norm, drop=0.3, num_graphs=2),
               v).eval()
    assert (tm.linear_0.bias is not None) == (norm is None)
    _close(tm(_t(x), batch=_t(lvl.batch), mask=_t(lvl.node_mask)),
           _apply(jm, v, _j(x), **kw))


# ---- pools and fusions ----------------------------------------------------

@pytest.mark.parametrize('mode', ['max', 'min', 'mean', 'sum', 'std'])
def test_pools_match_jax(nag, mode):
    """Level 0 into level 1: padded children (index == num_parents) and
    masked children out, empty parents 0."""
    lvl, par = nag.levels[0], nag.levels[1]
    x = _features(lvl.capacity, 8)
    args = (lvl.super_index, par.capacity)
    ref = jpool(mode, _j(x), _j(args[0]), args[1],
                     mask=_j(lvl.node_mask))
    got = tpool(mode, _t(x), _t(args[0]), args[1],
                     mask=_t(lvl.node_mask))
    _close(got, ref)


@pytest.mark.parametrize('cfg', [
    dict(), dict(k_rpe=True), dict(q_rpe=True, qk_scale='d+g'),
    dict(k_rpe=True, q_rpe=True, heads_share_rpe=True),
    dict(learnt_queries=True, k_rpe=True)],
    ids=['plain', 'k_rpe', 'q_rpe', 'heads_share', 'learnt_queries'])
def test_attentive_pool_matches_jax(nag, cfg):
    """The softmax over each parent's children, with the k/q RPE of
    vertical edge features: output and gradients."""
    lvl, par = nag.levels[0], nag.levels[1]
    xc, xp = _features(lvl.capacity, 8), _features(par.capacity, 6, seed=3)
    ea = _features(lvl.capacity, 5, seed=4)
    jm = JAttentivePool(dim=16, num_heads=4, qk_dim=2, **cfg)
    args = (lvl.super_index, par.capacity)
    jargs = (_j(xc), _j(xp), _j(args[0]), args[1])
    kw = dict(edge_attr=_j(ea), mask=_j(lvl.node_mask))
    v = _variables(jm, *jargs, **kw)
    w = _features(par.capacity, 16, seed=5)

    def loss(p, a):
        return (jm.apply({'params': p}, a, *jargs[1:], **kw) * w).sum()

    ref = _apply(jm, v, *jargs, **kw)
    gp, gx = jax.grad(loss, argnums=(0, 1))(v['params'], jargs[0])
    tm = _port(TAttentivePool(16, 8, parent_dim=6, num_heads=4,
                                   qk_dim=2, in_rpe_dim=5, **cfg), v)
    tx = _t(xc).requires_grad_()
    got = tm(tx, _t(xp), _t(args[0]), args[1], edge_attr=_t(ea),
             mask=_t(lvl.node_mask))
    _close(got, ref)
    (got * _t(w)).sum().backward()
    _close(tx.grad, gx)
    grads = dict(tm.named_parameters())
    for path, g in jax.tree_util.tree_leaves_with_path(gp):
        names = tuple(p.key for p in path)
        t = grads[jax_key_for(names)].grad
        _close(t.t() if names[-1] == 'kernel' else t, g)


@pytest.mark.parametrize('mode', ['cat', 'residual', 'first', 'second'])
def test_fusions_match_jax(mode):
    a, b = _features(10, 4), _features(10, 4, seed=3)
    _close(tstage.fuse(mode, _t(a), _t(b)), jstage.fuse(mode, _j(a), _j(b)))
    assert tstage.fuse(mode, None, _t(b)) is not None
    assert tstage.fuse(mode, _t(a), None) is not None


# ---- attention: the RPE variants, the qk scales ---------------------------

def _attention_args(nag, de=6):
    lvl = nag.levels[1]
    x = _features(lvl.capacity, 32, seed=3)
    ef = _features(lvl.capacity * lvl.nbr_idx.shape[1], de,
                   seed=4).reshape(lvl.capacity, -1, de)
    return lvl, x, ef


RPE_VARIANTS = {
    'k': dict(k_rpe=True), 'q': dict(q_rpe=True), 'v': dict(v_rpe=True),
    'kq': dict(k_rpe=True, q_rpe=True),
    'qk_share_minus': dict(k_rpe=True, q_rpe=True, qk_share_rpe=True,
                           q_on_minus_rpe=True),
    'q_minus': dict(q_rpe=True, v_rpe=True, q_on_minus_rpe=True),
    'heads_share': dict(k_rpe=True, q_rpe=True, v_rpe=True,
                        heads_share_rpe=True),
    'independent': dict(k_rpe=True, q_rpe=True, v_rpe=True),
    'none': dict()}


@pytest.mark.parametrize('train', [False, True])
@pytest.mark.parametrize('variant', sorted(RPE_VARIANTS))
def test_attention_rpe_variants_match_jax(nag, variant, train):
    """Each RPE set in evaluation (K1, or K2 for independent k/q/v) and
    in training (K1 with its closed-form backward): the block's output
    and its gradient with respect to the input."""
    lvl, x, ef = _attention_args(nag)
    cfg = dict(num_heads=4, qk_dim=4, in_rpe_dim=6, **RPE_VARIANTS[variant])
    jm = jattn.SelfAttentionBlock(dim=32, **cfg)
    jargs = (_j(lvl.nbr_idx), _j(lvl.nbr_mask))
    v = _variables(jm, _j(x), *jargs, edge_feat=_j(ef), train=False)
    w = _features(lvl.capacity, 32, seed=6)

    def out(a):
        return jm.apply(v, a, *jargs, edge_feat=_j(ef), train=train)

    ref, vjp = jax.vjp(out, _j(x))
    tm = _port(tattn.SelfAttentionBlock(32, **cfg), v).train(train)
    tx = _t(x).requires_grad_()
    got = tm(tx, _t(lvl.nbr_idx), _t(lvl.nbr_mask), _t(ef))
    _close(got, ref)
    (got * _t(w)).sum().backward()
    _close(tx.grad, vjp(_j(w))[0])


@pytest.mark.parametrize('qk_scale', ['d+g', 'd', 'g', 0.3])
def test_attention_qk_scales_match_jax(nag, qk_scale):
    lvl, x, ef = _attention_args(nag)
    cfg = dict(num_heads=4, qk_dim=4, in_rpe_dim=6, k_rpe=True,
               qk_scale=qk_scale)
    jm = jattn.SelfAttentionBlock(dim=32, **cfg)
    args = (_j(x), _j(lvl.nbr_idx), _j(lvl.nbr_mask))
    v = _variables(jm, *args, edge_feat=_j(ef), train=False)
    got = _port(tattn.SelfAttentionBlock(32, **cfg), v).eval()(
        _t(x), _t(lvl.nbr_idx), _t(lvl.nbr_mask), _t(ef))
    _close(got, _apply(jm, v, *args, edge_feat=_j(ef), train=False))


def test_attention_dropout_takes_the_materialized_route(nag):
    """attn_drop > 0 in training: JAX's own XLA route, the dropout on the
    materialized weights (at rate 0 on that route the output is K1's);
    in evaluation the kernel route, equal to the model without it."""
    lvl, x, ef = _attention_args(nag)
    cfg = dict(num_heads=4, qk_dim=4, in_rpe_dim=6, k_rpe=True, q_rpe=True)
    plain = tattn.SelfAttentionBlock(32, **cfg)
    drop = tattn.SelfAttentionBlock(32, attn_drop=0.5, **cfg)
    drop.load_state_dict(plain.state_dict())
    args = (_t(x), _t(lvl.nbr_idx), _t(lvl.nbr_mask), _t(ef))
    with torch.no_grad():
        assert torch.equal(plain.eval()(*args), drop.eval()(*args))
        drop.attn_drop.rate = 0.0
        _close(drop.train()(*args), plain.train()(*args).numpy())
        drop.attn_drop.rate = 0.5
        assert not torch.allclose(drop(*args), plain(*args))


# ---- transformer blocks: post-norm, DropPath ------------------------------

@pytest.mark.parametrize('pre_norm', [True, False])
@pytest.mark.parametrize('norm', ['graph', 'layer', 'instance', 'batch'])
def test_transformer_block_norms_match_jax(nag, norm, pre_norm):
    """Pre- and post-norm blocks with an FFN, each norm, and DropPath and
    residual dropout set (the identity in evaluation)."""
    lvl, x, ef = _attention_args(nag)
    cfg = dict(num_heads=4, qk_dim=4, in_rpe_dim=6, k_rpe=True, q_rpe=True,
               v_rpe=True, no_ffn=False, ffn_ratio=2, norm=norm,
               pre_norm=pre_norm, drop_path=0.3, residual_drop=0.2,
               num_graphs=2)
    jm = jtr.TransformerBlock(32, **cfg)
    kw = dict(nbr_idx=_j(lvl.nbr_idx), nbr_mask=_j(lvl.nbr_mask),
              edge_feat=_j(ef), mask=_j(lvl.node_mask), train=False)
    v = _variables(jm, _j(x), _j(lvl.batch), **kw)
    tm = _port(ttr.TransformerBlock(32, **cfg), v).eval()
    got = tm(_t(x), _t(lvl.batch), nbr_idx=_t(lvl.nbr_idx),
             nbr_mask=_t(lvl.nbr_mask), edge_feat=_t(ef),
             mask=_t(lvl.node_mask))
    valid = np.asarray(lvl.node_mask)
    _close(got, _apply(jm, v, _j(x), _j(lvl.batch), **kw), valid=valid)


def test_transformer_block_group_norm_raises_as_jax():
    with pytest.raises(TypeError):
        jtr.TransformerBlock(8, norm='group', no_sa=True).init(
            jax.random.PRNGKey(0), jnp.ones((4, 8)), jnp.zeros(4, jnp.int32))
    with pytest.raises(ValueError, match='group'):
        ttr.TransformerBlock(8, norm='group')


# ---- dropout statistics ----------------------------------------------------

@pytest.mark.parametrize('kind', ['dropout', 'drop_path'])
@pytest.mark.parametrize('rate', [0.1, 0.5])
def test_dropout_masks_statistics_and_repeat(kind, rate):
    rng = tdrop.DropoutRNG(seed=7)
    cls = tdrop.Dropout if kind == 'dropout' else tdrop.DropPath
    m = cls(rate, rng).train()
    x = torch.rand(4000, 16) + 1.0
    y = m(x)
    kept = y != 0
    if kind == 'drop_path':
        assert torch.equal(kept.all(1), kept.any(1))   # whole rows
        kept = kept[:, 0]
    n = kept.numel()
    share = kept.float().mean().item()
    assert abs(share - (1 - rate)) <= 3 * (rate * (1 - rate) / n) ** 0.5
    full = kept if kind == 'dropout' else kept[:, None].expand_as(x)
    torch.testing.assert_close(y[full], x[full] / (1 - rate))
    rng.manual_seed(7)
    assert torch.equal(m(x), y)
    assert not torch.equal(m(x), y)        # the stream moves on
    assert torch.equal(m.eval()(x), x)


# ---- the three narrow variant SPTs -----------------------------------------

HF = ('log_length', 'log_surface', 'log_volume', 'log_size')
BASE = dict(point_mlp=(12, 16, 32), down_dim=(32, 32),
            down_in_mlp=((40, 32, 32), (40, 32, 32)), down_num_heads=4,
            down_num_blocks=1, up_dim=(32,), up_in_mlp=((72, 32, 32),),
            up_num_heads=4, up_num_blocks=1, h_edge_mlp=(18, 16, 16),
            in_rpe_dim=16, qk_dim=4, num_graphs=2)
DROPS = dict(point_drop=0.1, down_mlp_drop=0.1, down_residual_drop=0.1,
             down_attn_drop=0.2, down_drop_path=0.2, up_mlp_drop=0.1,
             up_residual_drop=0.1, up_attn_drop=0.2, up_drop_path=0.2)
MODELS = {
    # q RPE through the shared k encoder on -edge features, one RPE for
    # all heads, another scale, post-norm layer norms
    'A': dict(qk_share_rpe=True, q_on_minus_rpe=True, heads_share_rpe=True,
              qk_scale='g', pre_norm=False, norm='layer'),
    # no edge features (no RPE): the attentive pool over vertical edge
    # features, residual fusions, batch norms, every dropout
    'B': dict(h_edge_mlp=None, in_rpe_dim=0, pool='attentive',
              v_edge_mlp=(4, 8, 8), fusion='residual', norm='batch',
              mlp_norm='batch', node_mlp=(4, 32),
              down_out_mlp=((32, 32), (32, 64)),
              down_in_mlp=((36, 32, 32), (36, 32, 32)),
              up_in_mlp=((68, 32, 32),)),
    # k RPE only, instance norms in the blocks and group norms in the
    # MLPs, min pooling; the share flags that do nothing in JAX
    'C': dict(q_rpe=False, v_rpe=False, norm='instance', mlp_norm='group',
              pool='min', node_mlp=(4, 4), stages_share_rpe=True,
              blocks_share_rpe=True)}


def _model_batch(batch, name):
    if MODELS[name].get('in_rpe_dim', 1):
        return batch
    return dataclasses.replace(batch, levels=tuple(
        dataclasses.replace(lvl, edge_feat=None) for lvl in batch.levels))


@pytest.fixture(scope='module')
def batch():
    nags = [random_nag(seed=0), random_nag(seed=1)]
    cfg = BatchConfig(sample_graph_r=-1, sample_segment_ratio=0,
                      segment_hf=HF,
                      v_edge_hf=('centroid_dir', 'centroid_dist'))
    return prepare_batch(nags, cfg, train=False, device=False)


@pytest.fixture(scope='module')
def jax_models(batch):
    """For each model: its variables, its logits in evaluation (dropout
    rates set) and one training loss and gradients (rates 0), the
    running statistics after it, and the spread of JAX's own gradients
    when every weight moves by about one f32 ulp (the gradients' own
    conditioning: a bias that a following norm removes has a gradient of
    rounding noise, and a near tie of a min pool or of a sharp softmax
    sends a gradient elsewhere)."""
    out = {}
    rng = jax.random.PRNGKey(0)
    for name, kw in MODELS.items():
        b = _model_batch(batch, name)
        net = dict(BASE, **kw)
        jm = JModel(net=JSPT(**net, **DROPS), num_classes=13)
        v = _variables(jm, b, train=False)
        logits = _apply(jm, v, b, train=False)
        task = JTask(net=JSPT(**net), num_classes=13)
        stats = v.get('batch_stats')
        step = jax.jit(jax.value_and_grad(
            lambda p: task._loss_fn(p, b, rng, batch_stats=stats),
            has_aux=True))
        (loss, (_, new_stats)), grads = step(v['params'])
        noise = np.random.default_rng(9)
        moved = jax.tree_util.tree_map(lambda a: (np.asarray(a) * (
            1 + 2.0 ** -23 * noise.standard_normal(a.shape))).astype(
            np.float32), v['params'])
        spread = jax.tree_util.tree_map(
            lambda a, c: float(np.abs(np.asarray(a) - np.asarray(c)).max()),
            grads, step(moved)[1])
        out[name] = dict(v=v, logits=[np.asarray(x) for x in logits],
                         loss=float(loss), grads=grads, spread=spread,
                         stats=new_stats)
    return out


# the share of gradient tensors that may take check_grads' L2 fallback
FALLBACK_SHARE = 0.1


def check_grads(model, grads, spread):
    """Each gradient of `model` against JAX's `grads`: its largest error
    within 1e-4 of its largest entry (test_torch_train.py's bound), or of
    four times JAX's own one-ulp `spread` where that is larger. A tensor
    that misses both is held within 1e-2 relative L2 instead
    (test_torch_train.py's update bound), and at most FALLBACK_SHARE of
    them may: the gradients of a GraphNorm's statistics are sums that
    the next norm cancels to a fraction of their terms (measured on the
    point-CNN SPT: the up stage's first MLP layer and norm, 7.7e-3 of
    the largest entry, 2.4e-3 L2), which one ulp of the weights does not
    reveal."""
    named = dict(model.named_parameters())
    spread = dict(jax.tree_util.tree_leaves_with_path(spread))
    leaves = jax.tree_util.tree_leaves_with_path(grads)
    fallback = []
    for path, g in leaves:
        names = tuple(p.key for p in path)
        t = named[jax_key_for(names)].grad.numpy()
        g = np.asarray(g)
        t = t.T if names[-1] == 'kernel' else t
        scale = max(float(np.abs(g).max()), 1e-6)
        err = float(np.abs(t - g).max())
        if err <= max(TOL_GRAD * scale, 4 * spread[path]):
            continue
        l2 = float(np.linalg.norm(t - g) / max(np.linalg.norm(g), 1e-12))
        assert l2 <= 1e-2, (names, err, scale, l2)
        fallback.append(names)
    assert len(fallback) <= FALLBACK_SHARE * len(leaves), fallback


def _port_model(name, v, drops=True):
    net = dict(BASE, **MODELS[name])
    task = SemanticTask(TSPT(**net, **(DROPS if drops else {}),
                             node_hf_dim=4, v_edge_dim=4), num_classes=13)
    load_jax_params(task.model, v['params'], v.get('batch_stats'))
    return task


def test_share_hf_mlps_over_two_levels_raises_as_jax(batch):
    """The JAX SPT names one MLP `node_mlp_shared` for every level, which
    flax refuses at the second; the port refuses it too."""
    net = dict(BASE, **MODELS['C'], share_hf_mlps=True)
    with pytest.raises(Exception, match='node_mlp_shared'):
        _variables(JModel(net=JSPT(**net), num_classes=13), batch,
                   train=False)
    with pytest.raises(ValueError, match='node_mlp_shared'):
        TSPT(**net)


@pytest.mark.parametrize('name', sorted(MODELS))
def test_variant_spt_logits_match_jax(batch, jax_models, name):
    b, ref = _model_batch(batch, name), jax_models[name]
    task = _port_model(name, ref['v'])
    task.model.eval()
    with torch.no_grad():
        got = task.model(from_numpy(b, 'cpu'))
    for lvl, g, r in zip(b.levels[1:], got, ref['logits']):
        valid = np.asarray(lvl.node_mask)
        assert np.isfinite(g.numpy()[valid]).all()
        _close(g, r, tol=TOL_SPT, valid=valid)


@pytest.mark.parametrize('name', sorted(MODELS))
def test_variant_spt_train_step_matches_jax(batch, jax_models, name):
    """The loss and every gradient of one training step (dropout rates 0),
    and BatchNorm's running statistics after it (`check_grads`)."""
    b, ref = _model_batch(batch, name), jax_models[name]
    task = _port_model(name, ref['v'], drops=False)
    task.model.train()
    loss, _ = task.loss(from_numpy(b, 'cpu', train=True))
    loss.backward()
    np.testing.assert_allclose(loss.item(), ref['loss'], rtol=TOL_LOSS)
    check_grads(task.model, ref['grads'], ref['spread'])
    if ref['stats'] is not None:
        buffers = dict(task.model.named_buffers())
        for path, s in jax.tree_util.tree_leaves_with_path(ref['stats']):
            key = jax_key_for(tuple(p.key for p in path))
            _close(buffers[key], s)


def test_variant_spt_dropout_reseeds_bit_equal(batch, jax_models):
    """Model B in training with every rate set: two runs from one seed
    are bit-equal, another seed draws other masks."""
    b = from_numpy(_model_batch(batch, 'B'), 'cpu', train=True)
    task = _port_model('B', jax_models['B']['v'])
    net = task.model.net
    task.model.train()
    outs = []
    for seed in (3, 3, 4):
        net.dropout_rng.manual_seed(seed)
        with torch.no_grad():
            outs.append(task.model(b)[0])
    assert torch.equal(outs[0], outs[1])
    assert not torch.equal(outs[0], outs[2])


# ---- the LR schedules ------------------------------------------------------

STEPS = [0, 1, 3, 5, 9, 10, 11, 15, 40, 99, 100, 101, 150]
SCHEDULES = {
    'step': dict(step_size=7, gamma=0.5),
    'multistep': dict(milestones=(5, 30, 60), gamma=0.25),
    'exponential': dict(gamma=0.96875),
    'cosine_power': dict(power=2.0, eta_min=1e-5),
    'cosine': dict()}


@pytest.mark.parametrize('strategy', ['cos', 'linear'])
@pytest.mark.parametrize('name', sorted(SCHEDULES))
def test_lr_schedules_match_jax(name, strategy):
    """Each schedule step by step, through `make_schedule` (10 warm-up
    steps of 100), at 1e-7 relative: the decays at powers of two, exact
    in JAX's f32. JAX evaluates the cosines in f32, which rounds them by
    up to 6e-9 of the peak LR 0.125 (4.7e-7 relative in the warm-up,
    more where 1 + cos cancels at the end of the anneal); the port in
    float64 is also held within one f32 ulp of the peak, 0.125 * 2^-23
    absolute (the existing cosine test's 1e-8)."""
    kw = dict(SCHEDULES[name], warmup_strategy=strategy)
    ref = jlr.make_schedule(name, 0.125, 100, num_warmup_steps=10, **kw)
    got = tlr.make_schedule(name, 0.125, 100, num_warmup_steps=10, **kw)
    np.testing.assert_allclose([got(s) for s in STEPS],
                               [float(ref(s)) for s in STEPS], rtol=1e-7,
                               atol=0.125 * 2 ** -23)
