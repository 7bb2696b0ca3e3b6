"""Reference-checkpoint import into the port
(`utils/import_ckpt.py:import_reference_checkpoint`) against the JAX
package's importer, on the CPU.

For each family the test builds a reference-format state_dict from JAX
parameters drawn with numpy (the JAX `reference_key_for` names each leaf;
Linear weights go [out, in], sparse-convolution kernels [K, in, out], as
the reference stores them), imports it into JAX and into the port, and
requires the port's parameters to equal the JAX-imported tree carried
across by `load_jax_params`, exactly, and the logits to match at the
forward tolerances of the families' own port tests. Families: the
flagship SPT-2 semantic model (full width for the parameters, narrow for
the logits), nano-2 semantic, the panoptic model with its edge-affinity
head, and EZ-SP's stage-1 `PartitionModel`. The EZ-SP point stage with a
sparse CNN is not in the port (`nn/stage.py:PointStage` raises), so only
its key grammar is checked. Strict mode: a missing key or a wrong shape
raises and writes nothing."""
import dataclasses

import numpy as np
import pytest
import torch

import jax

from superpoint_transformer_tpu.data.nag import NAG as JNAG
from superpoint_transformer_tpu.experiment import (
    build_batch_config as jbuild_batch_config, build_model as jbuild_model)
from superpoint_transformer_tpu.models import panoptic as jpan
from superpoint_transformer_tpu.models import partition as jpart
from superpoint_transformer_tpu.models.semantic import (
    SemanticSegmentationModel as JModel)
from superpoint_transformer_tpu.models.spt import SPT as JSPT
from superpoint_transformer_tpu.transforms import BatchConfig, prepare_batch
from superpoint_transformer_tpu.transforms import prepare as jprep
from superpoint_transformer_tpu.utils import synthetic as jsyn
from superpoint_transformer_tpu.utils import import_ckpt as jimp
from superpoint_transformer_tpu.utils.synthetic import random_nag
from superpoint_transformer_torch.data.padded import (
    from_numpy, point_cloud_from_numpy)
from superpoint_transformer_torch.experiment import (FLAGSHIP_CFG,
                                                     build_model)
from superpoint_transformer_torch.models import panoptic as tpan
from superpoint_transformer_torch.models import partition as tpart
from superpoint_transformer_torch.models.semantic import (
    SemanticSegmentationModel as TModel)
from superpoint_transformer_torch.models.spt import SPT as TSPT
from superpoint_transformer_torch.transforms import prepare as tprep
from superpoint_transformer_torch.utils import import_ckpt as timp
from superpoint_transformer_torch.utils import synthetic as tsyn
from superpoint_transformer_torch.utils.jax_params import load_jax_params
from test_torch_ezsp import CHANNELS, CNN_TOL, _nags
from test_torch_nano import _cfgs, _segment_features
from test_torch_spt import NARROW, TOL_F32, _params
from test_torch_trainer import one_torch_thread  # noqa: F401

# the sparse CNN's kernel volume (3^3 sites)
CONV_K = 27


def reference_state_dict(params):
    """A reference-format state_dict holding the flax `params`: each leaf
    under its JAX `reference_key_for` key, Linear kernels as [out, in],
    sparse-convolution kernels as [K, in, out]; plus the training extras
    a reference checkpoint carries, which the importers must ignore."""
    state = {}
    for path, value in jimp._tree_paths(params):
        key = jimp.reference_key_for(path)
        assert key is not None, f'unmapped parameter {path}'
        v = np.asarray(value)
        if key.endswith('.conv.kernel'):
            v = v.reshape(CONV_K, -1, v.shape[-1])
        elif path[-1] == 'kernel':
            v = v.T
        state[key] = torch.from_numpy(np.ascontiguousarray(v))
    state['criterion.criteria.0.weight'] = torch.ones(13)
    state['train_cm.confmat'] = torch.zeros(13, 13)
    return state


def import_both(params, module):
    """Import the reference state_dict of `params` into JAX (a zeroed
    tree) and into the port `module`; check full coverage on both sides
    and that the port holds exactly the JAX-imported tree."""
    state = reference_state_dict(params)
    zeros = jax.tree_util.tree_map(np.zeros_like, params)
    jparams, jrep = jimp.import_reference_checkpoint(state, zeros)
    report = timp.import_reference_checkpoint(state, module)
    assert not jrep['missing'] and not jrep['unused_reference_keys']
    assert not report['missing'] and not report['unused_reference_keys']
    assert len(report['mapped']) == len(jrep['mapped'])
    ref = load_jax_params(_zeroed_copy(module), jparams)
    got = dict(module.named_parameters())
    for name, p in ref.named_parameters():
        torch.testing.assert_close(got[name], p, rtol=0, atol=0,
                                   msg=name)
    return jparams


def _zeroed_copy(module):
    import copy
    out = copy.deepcopy(module)
    with torch.no_grad():
        for p in out.parameters():
            p.zero_()
    return out


def test_reference_keys_match_jax():
    """The port's key grammar is the JAX one on the paths of every
    family, the EZ-SP point stage's sparse CNN included."""
    paths = [
        ('net', 'first_stage', 'in_mlp', 'linear_0', 'kernel'),
        ('net', 'first_stage', 'in_mlp', 'norm_2', 'mean_scale'),
        ('net', 'down_stage_0', 'block_2', 'sa', 'qkv', 'kernel'),
        ('net', 'down_stage_1', 'block_0', 'sa', 'k_rpe', 'bias'),
        ('net', 'up_stage_0', 'block_0', 'sa_norm', 'weight'),
        ('net', 'up_stage_0', 'block_0', 'ffn', 'linear_1', 'kernel'),
        ('net', 'h_edge_mlp_1', 'linear_1', 'kernel'),
        ('net', 'v_edge_mlp_shared', 'norm_0', 'bias'),
        ('net', 'node_mlp_0', 'linear_0', 'bias'),
        ('head_0', 'classifier', 'kernel'), ('head', 'classifier', 'bias'),
        ('edge_affinity_head', 'linear_1', 'bias'),
        ('edge_affinity_head', 'other', 'bias'),
        ('net', 'first_stage', 'cnn', 'block_0', 'kernel'),
        ('net', 'first_stage', 'cnn', 'block_1', 'GraphNorm_0',
         'mean_scale'),
        ('cnn', 'block_0', 'kernel'), ('cnn', 'block_1', 'bias'),
        ('cnn', 'block_1', 'GraphNorm_0', 'weight'),
        ('cnn', 'block_1', 'Other', 'weight'),
        ('net', 'unknown_stage', 'x', 'kernel'), ('other', 'kernel'),
    ]
    for path in paths:
        for normed in (True, False):
            assert timp.reference_key_for(path, normed) \
                == jimp.reference_key_for(path, normed), path


def _semantic_batch(num_graphs=2):
    nags = [random_nag(seed=s) for s in range(num_graphs)]
    cfg = BatchConfig(sample_graph_r=-1, sample_segment_ratio=0)
    return prepare_batch(nags, cfg, train=False, device=False)


def _assert_logits(got, ref, batch, levels=None):
    levels = levels if levels is not None else batch.levels[1:]
    assert len(got) == len(ref) == len(levels)
    for lvl, g, r in zip(levels, got, ref):
        valid = np.asarray(lvl.node_mask)
        np.testing.assert_allclose(g.numpy()[valid], np.asarray(r)[valid],
                                   **TOL_F32)


def test_flagship_full_width_parameters_match_jax():
    """Every parameter of the flagship SPT-2 at full width (the
    JAX `__graft_entry__` model), drawn with numpy over its shapes."""
    from __graft_entry__ import _make_model
    jm = JModel(net=_make_model(num_graphs=2), num_classes=13)
    params = _params(jm, _semantic_batch())
    tm = TModel(build_model(FLAGSHIP_CFG, num_graphs=2, device='cpu'), 13)
    import_both(params, tm)


def test_flagship_narrow_logits_match_jax():
    batch = _semantic_batch()
    jm = JModel(net=JSPT(compute_dtype=None, **NARROW), num_classes=13)
    params = _params(jm, batch)
    tm = TModel(TSPT(compute_dtype=None, **NARROW), 13).eval()
    jparams = import_both(params, tm)
    ref = jax.jit(lambda p, b: jm.apply({'params': p}, b, train=False))(
        jparams, batch)
    with torch.inference_mode():
        got = tm(from_numpy(batch, 'cpu'))
    _assert_logits(got, ref, batch)


def test_nano_logits_match_jax():
    """nano-2 at its full width (no level 0; the first stage a
    transformer `Stage` on level 1)."""
    jcfg, cfg = _cfgs('semantic/s3dis_nano')
    bcfg = dataclasses.replace(jbuild_batch_config(jcfg),
                               sample_graph_r=-1, sample_segment_ratio=0)
    nags = []
    for seed in (0, 1):
        nag = random_nag(seed=seed, n_points=512)
        levels = [nag[1], nag[2]]
        _segment_features(levels, bcfg.segment_hf, seed)
        nags.append(JNAG(levels, start_i_level=1))
    batch = prepare_batch(nags, bcfg, train=False, device=False)
    jnet = jbuild_model(jcfg, num_graphs=2)
    jm = JModel(net=jnet, num_classes=13)
    params = _params(jm, batch)
    tm = TModel(build_model(cfg, num_graphs=2, device='cpu'), 13).eval()
    jparams = import_both(params, tm)
    ref = jm.apply({'params': jparams}, batch, train=False)
    with torch.inference_mode():
        got = tm(from_numpy(batch, 'cpu'))
    # nano: logits from level 1 up
    _assert_logits(got, ref, batch, levels=batch.levels)


def test_panoptic_logits_match_jax():
    """The panoptic model: the semantic logits of every level and the
    edge-affinity head's logits."""
    nags = [random_nag(seed=s, n_points=300, with_instances=True)
            for s in (0, 1)]
    cfg = BatchConfig(sample_graph_r=-1, sample_segment_ratio=0,
                      instance=True, instance_radius=10.0)
    batch = prepare_batch(nags, cfg, train=False, device=False)
    assert batch[1].obj_edge_index is not None
    jm = jpan.PanopticSegmentationModel(
        net=JSPT(compute_dtype=None, **NARROW), num_classes=13)
    params = _params(jm, batch)
    assert 'edge_affinity_head' in params
    tm = tpan.PanopticSegmentationModel(
        TSPT(compute_dtype=None, **NARROW), 13).eval()
    jparams = import_both(params, tm)
    ref, ref_ea = jm.apply({'params': jparams}, batch, train=False)
    with torch.inference_mode():
        got, got_ea = tm(from_numpy(batch, 'cpu', train=True))
    _assert_logits(got, ref, batch)
    mask = np.asarray(batch[1].obj_edge_mask)
    assert mask.any()
    np.testing.assert_allclose(got_ea.numpy()[mask],
                               np.asarray(ref_ea)[mask], **TOL_F32)


def test_partition_model_embeddings_match_jax():
    """EZ-SP's stage-1 `PartitionModel`: the sparse CNN's [K, in, out]
    kernels reshaped to the port's [out, K*in] weights."""
    tcfg = tprep.BatchConfig(num_classes=13, max_num_nodes=300)
    jcfg = BatchConfig(num_classes=13, max_num_nodes=300)
    host = tprep.prepare_partition_batch(
        _nags(tsyn, (0, 1)), tcfg, rng=np.random.default_rng(0),
        node_cap=640, edge_cap=8_192)
    jhost = jprep.prepare_partition_batch(
        _nags(jsyn, (0, 1)), jcfg, rng=np.random.default_rng(0),
        node_cap=640, edge_cap=8_192)
    assert np.asarray(host.cnn_nbr_idx).shape[1] == CONV_K
    jm = jpart.PartitionModel(channels=CHANNELS, num_graphs=2)
    params = jax.tree_util.tree_map(
        np.asarray, jm.init(jax.random.PRNGKey(0), jhost)['params'])
    # non-trivial norm parameters, so that a swap would show
    rng = np.random.default_rng(1)
    params = jax.tree_util.tree_map(
        lambda a: (a + 0.1 * rng.standard_normal(a.shape)).astype(a.dtype),
        params)
    tm = tpart.PartitionModel(8, channels=CHANNELS, num_graphs=2)
    jparams = import_both(params, tm)
    ref = jm.apply({'params': jparams}, jhost)
    with torch.no_grad():
        got = tm(point_cloud_from_numpy(host, 'cpu'))
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=CNN_TOL,
                               atol=CNN_TOL)


@pytest.fixture(scope='module')
def narrow():
    batch = _semantic_batch()
    jm = JModel(net=JSPT(compute_dtype=None, **NARROW), num_classes=13)
    return _params(jm, batch)


def _narrow_module():
    return TModel(TSPT(compute_dtype=None, **NARROW), 13)


def _snapshot(module):
    return {k: v.clone() for k, v in module.state_dict().items()}


def test_missing_key_raises_in_strict_mode_and_writes_nothing(narrow):
    state = reference_state_dict(narrow)
    key = 'net.down_stages.0.transformer_blocks.0.sa.qkv.weight'
    del state[key]
    tm = _narrow_module()
    before = _snapshot(tm)
    with pytest.raises(ValueError, match='no reference source'):
        timp.import_reference_checkpoint(state, tm, strict=True)
    for k, v in tm.state_dict().items():
        assert torch.equal(v, before[k]), k
    # not strict: the parameter keeps its value and is reported
    report = timp.import_reference_checkpoint(state, tm, strict=False)
    assert report['missing'] == ['net.down_stage_0.block_0.sa.qkv.weight']
    assert torch.equal(tm.net.down_stage_0.block_0.sa.qkv.weight,
                       before['net.down_stage_0.block_0.sa.qkv.weight'])


def test_wrong_shape_raises_and_writes_nothing(narrow):
    state = reference_state_dict(narrow)
    key = 'net.down_stages.0.transformer_blocks.0.sa.qkv.weight'
    state[key] = state[key][:, :-1]
    tm = _narrow_module()
    before = _snapshot(tm)
    for strict in (True, False):
        with pytest.raises(ValueError, match='shape mismatch'):
            timp.import_reference_checkpoint(state, tm, strict=strict)
    for k, v in tm.state_dict().items():
        assert torch.equal(v, before[k]), k


def test_checkpoint_file_and_unused_keys(narrow, tmp_path):
    """A Lightning-style file ({'state_dict': ...}) loads like the dict;
    a key nothing takes is reported, the training extras are not."""
    state = reference_state_dict(narrow)
    state['net.extra.weight'] = torch.zeros(3)
    path = tmp_path / 'reference.ckpt'
    torch.save({'state_dict': state, 'epoch': 3}, path)
    a, b = _narrow_module(), _narrow_module()
    report = timp.import_reference_checkpoint(str(path), a)
    assert report['unused_reference_keys'] == ['net.extra.weight']
    assert timp.import_reference_checkpoint(state, b) == report
    for (ka, va), (kb, vb) in zip(a.state_dict().items(),
                                  b.state_dict().items()):
        assert ka == kb and torch.equal(va, vb)
