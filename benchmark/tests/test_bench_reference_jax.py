"""The plain reference against the JAX package's SPT on the CPU, at a
small size: the same padded batch (the JAX host path's) and the same
weights give the same logits in float32. The only test of the benchmark
that loads JAX; it runs on the CPU and shares its file with no card
test."""
import os

os.environ.setdefault('JAX_PLATFORMS', 'cpu')

import jax  # noqa: E402
import numpy as np  # noqa: E402
import torch  # noqa: E402

from superpoint_transformer_tpu.models.semantic import (  # noqa: E402
    SemanticSegmentationModel as JModel)
from superpoint_transformer_tpu.models.spt import SPT as JSPT  # noqa: E402
from superpoint_transformer_tpu.transforms import (  # noqa: E402
    BatchConfig, prepare_batch)
from superpoint_transformer_tpu.utils.synthetic import random_nag  # noqa

from benchmark.reference import spt as ref  # noqa: E402

# two 32-wide down stages of 2 blocks, one up stage, 4 heads of qk_dim 4
NARROW = dict(point_mlp=(12, 16, 32), down_dim=(32, 32),
              down_in_mlp=((36, 32, 32), (36, 32, 32)), down_num_heads=4,
              down_num_blocks=2, up_dim=(32,), up_in_mlp=((68, 32, 32),),
              up_num_heads=4, up_num_blocks=1, h_edge_mlp=(18, 16, 16),
              in_rpe_dim=16, qk_dim=4, num_graphs=2)
MODEL = dict(point_hf_dim=8, edge_hf_dim=18, point_mlp=[16, 32],
             down_dim=[32, 32], up_dim=[32], mlp_depth=2, h_edge_mlp_out=16,
             num_heads=4, qk_dim=4, down_num_blocks=2, up_num_blocks=1,
             num_classes=13)
# f32 on both sides over ~20 layers in another summation order
TOL = dict(rtol=1e-4, atol=1e-4)


def _flat(tree, prefix=()):
    for k, v in tree.items():
        if isinstance(v, dict) or hasattr(v, 'items'):
            yield from _flat(v, prefix + (k,))
        else:
            yield prefix + (k,), v


def test_reference_matches_the_jax_model():
    nags = [random_nag(seed=0), random_nag(seed=1)]
    batch = prepare_batch(nags, BatchConfig(sample_graph_r=-1,
                                            sample_segment_ratio=0),
                          train=False, device=False)
    jm = JModel(net=JSPT(compute_dtype=None, **NARROW), num_classes=13)
    shapes = jax.eval_shape(lambda: jm.init(
        jax.random.PRNGKey(0), batch, train=False))['params']
    rng = np.random.default_rng(0)

    def draw(path, leaf):
        r = rng.standard_normal(leaf.shape).astype(np.float32)
        if path[-1].key == 'kernel':
            return r / np.sqrt(leaf.shape[0])
        return r * 0.1 + (path[-1].key in ('weight', 'mean_scale'))

    params = jax.tree_util.tree_map_with_path(draw, shapes)
    want = jm.apply({'params': params}, batch, train=False)
    weights = {}
    for path, v in _flat(params):
        *mods, leaf = path
        v = np.asarray(v, np.float32)
        weights['.'.join(mods + ['weight' if leaf == 'kernel' else leaf])] = \
            torch.from_numpy(v.T.copy() if leaf == 'kernel' else v)
    assert set(weights) == {n for n, _ in ref.param_shapes(MODEL)}
    with torch.no_grad():
        got = ref.forward(MODEL, weights, ref.levels_from_host(batch, 'cpu'),
                          2)
    assert len(got) == len(want) == 2
    for lvl, g, w in zip(batch.levels[1:], got, want):
        n = int(lvl.num_nodes)
        np.testing.assert_allclose(g.numpy(), np.asarray(w)[:n], **TOL)
