"""`ops/gather.py:gather_rows_t` vs the JAX package's `gather_rows_t`
(the gather whose backward runs over the transpose neighbor table), and
the training step that now takes it, narrow and at the flagship's
widths, vs the JAX `SemanticTask` on the same batch with its transpose
tables."""
import numpy as np
import pytest
import torch
import torch.nn.functional as F

import jax
import jax.numpy as jnp

from superpoint_transformer_tpu import experiment as jexp
from superpoint_transformer_tpu.config.loader import load_config as jload
from superpoint_transformer_tpu.models.semantic import SemanticTask as JTask
from superpoint_transformer_tpu.models.spt import SPT as JSPT
from superpoint_transformer_tpu.ops.gather import gather_rows_t as jgather
from superpoint_transformer_torch.config.loader import load_config
from superpoint_transformer_torch.data.pad import transpose_neighbors
from superpoint_transformer_torch.data.padded import from_numpy
from superpoint_transformer_torch.experiment import build_model
from superpoint_transformer_torch.models.semantic import SemanticTask
from superpoint_transformer_torch.models.spt import SPT as TSPT
from superpoint_transformer_torch.nn import attention as block
from superpoint_transformer_torch.ops.gather import gather_rows_t
from superpoint_transformer_torch.train import CONFIG_DIR
from superpoint_transformer_torch.utils.jax_params import load_jax_params
from tests.test_torch_train import (HPARAMS, NARROW, TOL_F32, _flat,
                                    _params)
from tests.test_torch_train import batch  # noqa: F401 (module fixture)

# f32: each row's gradient is a sum of ~K cotangents of size ~1, in
# another order than the embedding backward's (the JAX test's shapes)
TOL = 1e-6
VALID = 56


def _table(seed, n=64, k=8, c=5):
    """A neighbor table over the first VALID rows, with padded rows and
    slots (pointing at node 0, mask False), and its transpose."""
    rng = np.random.default_rng(seed)
    idx = rng.integers(0, VALID, (n, k)).astype(np.int32)
    mask = rng.random((n, k)) < 0.8
    mask[VALID:] = False
    idx[~mask] = 0
    in_idx, in_mask = transpose_neighbors(idx, mask)
    table = rng.standard_normal((n, c)).astype(np.float32)
    g = rng.standard_normal((n, k, c)).astype(np.float32)
    return table, idx, mask, in_idx, in_mask, g


@pytest.mark.parametrize('seed', [0, 1])
def test_gather_rows_t_matches_jax_and_embedding(seed):
    table, idx, mask, in_idx, in_mask, g = _table(seed)
    ref, vjp = jax.vjp(lambda t: jgather(t, jnp.asarray(idx),
                                         jnp.asarray(in_idx),
                                         jnp.asarray(in_mask)),
                       jnp.asarray(table))
    # the cotangent of an invalid slot never reaches the table: the
    # attention's weights are zero there, so g is zero there too
    g = g * mask[..., None]
    ref_grad, = vjp(jnp.asarray(g))
    t = torch.from_numpy(table).requires_grad_()
    args = [torch.from_numpy(a).long() for a in (idx, in_idx)]
    out = gather_rows_t(t, args[0], args[1], torch.from_numpy(in_mask))
    np.testing.assert_array_equal(out.detach().numpy(), np.asarray(ref))
    out.backward(torch.from_numpy(g))
    np.testing.assert_allclose(t.grad.numpy(), np.asarray(ref_grad),
                               rtol=TOL, atol=TOL)
    e = torch.from_numpy(table).requires_grad_()
    F.embedding(args[0], e).backward(torch.from_numpy(g))
    np.testing.assert_allclose(t.grad.numpy(), e.grad.numpy(), rtol=TOL,
                               atol=TOL)
    assert np.all(t.grad.numpy()[VALID:] == 0)


def test_gather_rows_t_bf16_sums_in_f32():
    """A bf16 table's gradient is the f32 sum of its bf16 cotangents,
    rounded to bf16 once."""
    table, idx, mask, in_idx, in_mask, g = _table(2)
    g = torch.from_numpy(g * mask[..., None]).to(torch.bfloat16)
    t = torch.from_numpy(table).to(torch.bfloat16).requires_grad_()
    out = gather_rows_t(t, torch.from_numpy(idx).long(),
                        torch.from_numpy(in_idx).long(),
                        torch.from_numpy(in_mask))
    assert out.dtype == torch.bfloat16
    out.backward(g)
    e = torch.from_numpy(table).requires_grad_()
    F.embedding(torch.from_numpy(idx).long(), e).backward(g.float())
    assert t.grad.dtype == torch.bfloat16
    np.testing.assert_array_equal(t.grad.float().numpy(),
                                  e.grad.to(torch.bfloat16).float().numpy())


@pytest.fixture
def counted(monkeypatch):
    """Count the attention block's calls of gather_rows_t."""
    calls = []

    def wrapped(*args):
        calls.append(args[0].shape)
        return gather_rows_t(*args)

    monkeypatch.setattr(block, 'gather_rows_t', wrapped)
    return calls


def _nets(width):
    """(JAX SPT, port SPT, attention blocks) of the narrow SPT or of the
    flagship SPT-2 (`experiment=semantic/s3dis` in f32)."""
    if width == 'narrow':
        blocks = 2 * NARROW['down_num_blocks'] + NARROW['up_num_blocks']
        return JSPT(**NARROW), TSPT(**NARROW), blocks
    argv = ['experiment=semantic/s3dis', 'trainer.precision=32']
    return (jexp.build_model(jload(CONFIG_DIR, 'train', argv),
                             num_graphs=2),
            build_model(load_config(CONFIG_DIR, 'train', argv),
                        num_graphs=2, device='cpu'), 3 + 3 + 1)


@pytest.mark.parametrize('width', ['narrow', 'flagship'])
def test_train_step_with_transpose_tables_matches_jax(batch, counted,
                                                      width):
    """The SPT's loss and gradients with the transpose tables on both
    sides (the JAX training route's gather_rows_t), narrow and at the
    flagship's widths, at the f32 tolerances of test_torch_train.py;
    every attention block gathers through gather_rows_t in training,
    none in evaluation."""
    assert batch.levels[1].nbr_in_idx is not None
    jnet, net, blocks = _nets(width)
    jtask = JTask(net=jnet, num_classes=13, **HPARAMS)
    params = _params(jtask.model, batch)
    loss, grads = jax.jit(jax.value_and_grad(
        lambda p: jtask._loss_fn(p, batch, jax.random.PRNGKey(0))[0]))(
        params)
    grads = _flat(grads)

    task = SemanticTask(net, num_classes=13, **HPARAMS)
    load_jax_params(task.model, params)
    tb = from_numpy(batch, 'cpu', None, train=True)
    assert tb[1].nbr_in_idx is not None and tb[2].nbr_in_idx is not None
    task.model.train()
    got, _ = task.loss(tb)
    got.backward()
    assert len(counted) == blocks
    np.testing.assert_allclose(got.item(), float(loss),
                               rtol=TOL_F32['loss'])
    for key, p in task.model.named_parameters():
        g = grads[key]
        scale = max(float(np.abs(g).max()), 1e-6)
        err = float(np.abs(p.grad.numpy() - g).max())
        assert err <= TOL_F32['rel'] * scale, \
            f'{key}: gradient max err {err:.3e} vs |ref| {scale:.3e}'
    task.eval_step(tb)
    assert len(counted) == blocks
