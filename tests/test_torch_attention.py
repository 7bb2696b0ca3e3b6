"""The port's dense attention (plain version of the K1 kernel and its
closed-form backward, superpoint_transformer_torch/ops/attention.py) vs
the JAX Pallas kernel `dense_attention_pallas` and its custom VJP, run in
TPU interpret mode as tests/test_pallas_attention.py runs them on the
CPU. The CUDA kernel itself is checked against the plain version by
tests/test_torch_cuda.py (on the card) and by chip_smoke.py."""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax.experimental.pallas import tpu as pltpu

from superpoint_transformer_tpu.ops.pallas_attention import (
    dense_attention_pallas, dense_attention_pallas_trainable)
from superpoint_transformer_torch.ops.attention import (
    dense_attention, dense_attention_bwd, dense_attention_reference,
    dense_attention_trainable)

# tests/test_pallas_attention.py's tolerance for K1 (f32)
TOL = dict(rtol=3e-5, atol=3e-5)


def _inputs(q_per_edge, seed=0, N=256, K=16, H=4, D=4, C=4,
            masked_rows=0):
    """numpy inputs drawn as tests/test_pallas_attention.py draws them."""
    rng = np.random.default_rng(seed)
    qshape = (N, K, H, D) if q_per_edge else (N, H, D)
    q = rng.normal(size=qshape).astype(np.float32)
    k = rng.normal(size=(N, K, H, D)).astype(np.float32)
    v = rng.normal(size=(N, K, H, C)).astype(np.float32)
    mask = rng.random((N, K)) > 0.3
    if masked_rows:
        mask[-masked_rows:] = False
    scale = (rng.random(N) + 0.5).astype(np.float32)
    return q, k, v, mask, scale


def _jax(args, dtype=jnp.float32):
    q, k, v, mask, scale = args
    return (jnp.asarray(q, dtype), jnp.asarray(k, dtype),
            jnp.asarray(v, dtype), jnp.asarray(mask), jnp.asarray(scale))


def _torch(args, dtype=torch.float32):
    q, k, v, mask, scale = (torch.from_numpy(a) for a in args)
    return q.to(dtype), k.to(dtype), v.to(dtype), mask, scale


@pytest.mark.parametrize('dtype', ['float32', 'bfloat16'])
@pytest.mark.parametrize('q_per_edge', [False, True],
                         ids=['q_node', 'q_edge'])
def test_plain_matches_pallas_interpret(q_per_edge, dtype):
    """Both q layouts, with fully masked rows. bf16 inputs: both sides
    round q*scale to bf16 and then compute in f32, so the f32 tolerance
    holds."""
    args = _inputs(q_per_edge, seed=int(q_per_edge), masked_rows=16)
    with pltpu.force_tpu_interpret_mode():
        ref = np.asarray(dense_attention_pallas(
            *_jax(args, getattr(jnp, dtype)), block_n=128))
    got = dense_attention_reference(*_torch(args, getattr(torch, dtype)))
    assert got.shape == ref.shape and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), ref, **TOL)
    # a fully masked row gives 0, not NaN
    assert np.all(got.numpy()[-16:] == 0)


@pytest.mark.parametrize('q_per_edge', [False, True],
                         ids=['q_node', 'q_edge'])
def test_backward_matches_jax_custom_vjp(q_per_edge):
    """dq, dk, dv, dscale vs `jax.grad` of the trainable Pallas kernel (its
    backward is XLA autodiff of the plain expression), under a random
    cotangent, with fully masked rows."""
    args = _inputs(q_per_edge, seed=2, N=128, K=8, H=2, masked_rows=8)
    w = np.random.default_rng(3).standard_normal(
        (128, 2, 4)).astype(np.float32)
    q, k, v, mask, scale = _jax(args)

    def loss(q, k, v, scale):
        return (dense_attention_pallas_trainable(q, k, v, mask, scale)
                * w).sum()

    with pltpu.force_tpu_interpret_mode():
        ref = jax.grad(loss, argnums=(0, 1, 2, 3))(q, k, v, scale)
    tq, tk, tv, tm, ts = _torch(args)
    got = dense_attention_bwd(tq, tk, tv, tm, ts, torch.from_numpy(w))
    for name, a, b in zip(('dq', 'dk', 'dv', 'dscale'), got, ref):
        assert a.shape == b.shape, name
        np.testing.assert_allclose(a.numpy(), np.asarray(b), **TOL,
                                   err_msg=name)


@pytest.mark.parametrize('q_per_edge', [False, True],
                         ids=['q_node', 'q_edge'])
def test_trainable_gradients_match_autograd_of_plain(q_per_edge):
    """The autograd function (plain forward on the CPU, closed-form
    backward) vs torch autograd through the plain forward."""
    args = _torch(_inputs(q_per_edge, seed=4, N=64, K=8, masked_rows=4))
    w = torch.randn(64, 4, 4, generator=torch.Generator().manual_seed(5))
    grads = []
    for fn in (dense_attention_trainable, dense_attention_reference):
        q, k, v, mask, scale = (a.clone().requires_grad_(a.is_floating_point())
                                for a in args)
        (fn(q, k, v, mask, scale) * w).sum().backward()
        grads.append([t.grad for t in (q, k, v, scale)])
    for a, b in zip(*grads):
        torch.testing.assert_close(a, b, **TOL)


def test_wrapper_routes_cpu_tensors_to_plain_version():
    args = _torch(_inputs(True, seed=6))
    before = dense_attention.launches
    assert torch.equal(dense_attention(*args),
                       dense_attention_reference(*args))
    assert dense_attention.launches == before


def test_wrapper_checks_layouts_on_every_device():
    q, k, v, mask, scale = _torch(_inputs(False, seed=7, N=8, K=4))
    with pytest.raises(ValueError, match='CUDA'):
        dense_attention(q.to('meta'), k.to('meta'), v.to('meta'),
                        mask.to('meta'), scale.to('meta'))
    with pytest.raises(ValueError, match='dtype'):
        dense_attention(q, k.to(torch.bfloat16), v, mask, scale)
    with pytest.raises(ValueError, match='contiguous'):
        dense_attention(q, k.transpose(0, 1).contiguous().transpose(0, 1),
                        v, mask, scale)
