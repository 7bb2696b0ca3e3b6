"""The port's whole inference slice vs the JAX package: a narrow SPT on a
batch made by the JAX host path, in f32 and bf16; the flagship config
and parameter count; NAG-order predictions from `infer_batch`.

On the CPU the JAX model takes its XLA attention path (the Pallas
kernels need a non-CPU backend), so the K2 kernel's math is pinned
separately by test_torch_attention_rpe.py."""
import os

import numpy as np
import pytest
import torch

import jax

from superpoint_transformer_tpu import inference as jinf
from superpoint_transformer_tpu.models.semantic import (
    SemanticSegmentationModel as JModel)
from superpoint_transformer_tpu.models.spt import SPT as JSPT
from superpoint_transformer_tpu.transforms import BatchConfig, prepare_batch
from superpoint_transformer_tpu.utils.synthetic import random_nag
from superpoint_transformer_torch.data.padded import from_numpy
from superpoint_transformer_torch.experiment import (FLAGSHIP_CFG,
                                                     build_model, build_task)
from superpoint_transformer_torch.inference import infer_batch
from superpoint_transformer_torch.models.semantic import (
    SemanticSegmentationModel as TModel)
from superpoint_transformer_torch.models.spt import SPT as TSPT
from superpoint_transformer_torch.utils.jax_params import load_jax_params

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

# point MLP (12,16,32); two 32-wide down stages of 2 blocks; one up
# stage; 4 heads of qk_dim 4, so H*D = 16 != C = 32
NARROW = dict(point_mlp=(12, 16, 32), down_dim=(32, 32),
              down_in_mlp=((36, 32, 32), (36, 32, 32)), down_num_heads=4,
              down_num_blocks=2, up_dim=(32,), up_in_mlp=((68, 32, 32),),
              up_num_heads=4, up_num_blocks=1, h_edge_mlp=(18, 16, 16),
              in_rpe_dim=16, qk_dim=4, num_graphs=2)
# f32 through the whole network: O(1-10) logits after ~20 layers of
# f32 rounding in another summation order
TOL_F32 = dict(rtol=1e-4, atol=1e-4)
# bf16 compute: both sides round to bf16 (2^-8 relative), but at other
# points (PyTorch after every op; XLA:CPU only at fusion boundaries; the
# K2 kernel keeps f32 where the JAX XLA attention rounds to bf16), over
# ~20 layers. On this batch the logits (|x| up to ~6) differ by 0.37 at
# most and 0.05 on average, about as far as JAX's own bf16 logits are
# from its f32 ones (0.23 / 0.04). Near-ties of random-weight logits
# flip under that noise: argmax agreement measured 0.92 and 0.94.
TOL_BF16 = dict(rtol=0.1, atol=0.5)
MEAN_ABS_BF16 = 0.1
ARGMAX_AGREEMENT_BF16 = 0.85


@pytest.fixture(scope='module')
def batch():
    """A 2-graph inference batch from the JAX host path (numpy
    leaves)."""
    nags = [random_nag(seed=0), random_nag(seed=1)]
    cfg = BatchConfig(sample_graph_r=-1, sample_segment_ratio=0)
    return prepare_batch(nags, cfg, train=False, device=False)


def _params(model, batch):
    """Random flax params drawn with numpy over the `eval_shape` tree."""
    shapes = jax.eval_shape(lambda: model.init(
        jax.random.PRNGKey(0), batch, train=False))['params']
    rng = np.random.default_rng(0)

    def draw(path, leaf):
        name = path[-1].key
        r = rng.standard_normal(leaf.shape).astype(np.float32)
        if name == 'kernel':
            return r / np.sqrt(leaf.shape[0])
        return r * 0.1 + (name in ('weight', 'mean_scale'))

    return jax.tree_util.tree_map_with_path(draw, shapes)


def _pair(batch, compute_dtype):
    jm = JModel(net=JSPT(compute_dtype=compute_dtype, **NARROW),
                num_classes=13)
    params = _params(jm, batch)
    ref = jax.jit(lambda p, b: jm.apply({'params': p}, b, train=False))(
        params, batch)
    tm = TModel(TSPT(compute_dtype=compute_dtype, **NARROW), 13)
    load_jax_params(tm, params).eval()
    return [np.asarray(r) for r in ref], tm


@pytest.mark.parametrize('compute_dtype', [None, 'bfloat16'])
def test_narrow_spt_matches_jax(batch, compute_dtype):
    ref, tm = _pair(batch, compute_dtype)
    with torch.inference_mode():
        got = tm(from_numpy(batch, 'cpu', compute_dtype))
    assert len(got) == len(ref) == 2
    for lvl, g, r in zip(batch.levels[1:], got, ref):
        valid = np.asarray(lvl.node_mask)
        g, r = g.numpy()[valid], r[valid]
        assert np.isfinite(g).all()
        if compute_dtype is None:
            np.testing.assert_allclose(g, r, **TOL_F32)
        else:
            np.testing.assert_allclose(g, r, **TOL_BF16)
            assert np.abs(g - r).mean() < MEAN_ABS_BF16
            agree = (g.argmax(1) == r.argmax(1)).mean()
            assert agree >= ARGMAX_AGREEMENT_BF16, agree


def test_infer_batch_predictions_in_nag_order(batch):
    ref, tm = _pair(batch, None)
    n1 = int(batch.levels[1].num_nodes)
    nid = jinf.level1_node_id(batch, n1)
    assert not np.array_equal(nid, np.arange(n1))   # the sort moved rows
    expect = jinf.to_nag_order(ref[0][:n1].argmax(1), nid)
    got = infer_batch(tm, from_numpy(batch, 'cpu'))
    np.testing.assert_array_equal(got, expect)


def _leaves(tree, prefix=''):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _leaves(v, f'{prefix}.{k}' if prefix else k)
    else:
        yield prefix, tree


def test_flagship_cfg_equals_yaml_composition():
    from superpoint_transformer_tpu.config.loader import load_config
    cfg = load_config(os.path.join(REPO, 'configs'), 'train',
                      ['experiment=semantic/s3dis'])
    for path, value in _leaves(FLAGSHIP_CFG):
        assert cfg.get_path(path) == value, path
    # the port builds the same network from either
    a = build_model(FLAGSHIP_CFG, num_graphs=8, device='cpu')
    b = build_model(cfg, num_graphs=8, device='cpu')
    assert {k: v.shape for k, v in a.state_dict().items()} == \
        {k: v.shape for k, v in b.state_dict().items()}


def test_flagship_parameter_count_matches_jax():
    from __graft_entry__ import _make_model
    cfg = BatchConfig(sample_graph_r=-1, sample_segment_ratio=0)
    small = prepare_batch([random_nag(seed=0)], cfg, train=False,
                          device=False)
    jm = JModel(net=_make_model(num_graphs=8), num_classes=13)
    shapes = jax.eval_shape(lambda: jm.init(
        jax.random.PRNGKey(0), small, train=False))['params']
    n_jax = sum(int(np.prod(x.shape))
                for x in jax.tree_util.tree_leaves(shapes))
    tm = TModel(build_model(FLAGSHIP_CFG, num_graphs=8, device='cpu'), 13)
    n_port = sum(p.numel() for p in tm.parameters())
    assert n_port == n_jax
    assert 200_000 < n_port < 220_000
    # and every flax parameter has its counterpart, shape for shape
    load_jax_params(tm, jax.tree_util.tree_map(
        lambda x: np.zeros(x.shape, np.float32), shapes))


@pytest.mark.parametrize('entry', [build_model, build_task],
                         ids=['build_model', 'build_task'])
def test_entry_points_build_on_the_card_unless_asked_for_the_cpu(entry):
    """With no device given, the entry points build on the card: on a
    machine without one they raise, never falling back to the CPU. With
    device='cpu' every parameter is on the CPU."""
    if torch.cuda.is_available():
        built = entry(FLAGSHIP_CFG, num_graphs=2)
        module = built.model if entry is build_task else built
        assert all(p.is_cuda for p in module.parameters())
    else:
        with pytest.raises(RuntimeError, match='no CUDA device'):
            entry(FLAGSHIP_CFG, num_graphs=2)
    built = entry(FLAGSHIP_CFG, num_graphs=2, device='cpu')
    module = built.model if entry is build_task else built
    assert all(p.device.type == 'cpu' for p in module.parameters())
