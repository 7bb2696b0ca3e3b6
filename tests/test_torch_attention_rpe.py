"""The port's streaming RPE attention and its backward (plain versions of
the K2 and K3 kernels, superpoint_transformer_torch/ops/attention_rpe.py)
vs the JAX Pallas kernels `dense_attention_rpe_pallas` and
`dense_attention_rpe_bwd_pallas` run in TPU interpret mode, as
tests/test_pallas_attention.py runs them on the CPU, and vs the JAX
package's `_rpe_xla_reference`. The CUDA kernels themselves are checked
against the plain versions by tests/test_torch_cuda.py (on the card) and
by chip_smoke.py."""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from superpoint_transformer_tpu.ops.pallas_attention import (
    dense_attention_rpe_bwd_pallas, dense_attention_rpe_pallas,
    _rpe_xla_reference)
from superpoint_transformer_torch.ops.attention_rpe import (
    dense_attention_rpe, dense_attention_rpe_bwd,
    dense_attention_rpe_bwd_reference, dense_attention_rpe_reference,
    dense_attention_rpe_trainable)

# the JAX kernel test's own tolerance (f32)
RTOL, ATOL = 2e-4, 2e-5


def _inputs(seed=0, N=256, K=16, H=4, D=4, C=32, De=8, masked_rows=0):
    """numpy inputs at the shapes of tests/test_pallas_attention.py
    `_rpe_inputs` (scale and mask drawn the same way)."""
    rng = np.random.default_rng(seed)

    def mk(*s):
        return rng.standard_normal(s).astype(np.float32)

    args = [mk(N, H, D), mk(N, K, H * D), mk(N, K, C), mk(N, K, De),
            mk(De, H * D) * 0.3, mk(H * D) * 0.1, mk(De, H * D) * 0.3,
            mk(H * D) * 0.1, mk(De, C) * 0.3, mk(C) * 0.1]
    mask = rng.random((N, K)) < 0.7
    mask[:, 0] = True
    if masked_rows:
        mask[-masked_rows:] = False
    scale = (rng.random(N) * 0.5 + 0.2).astype(np.float32)
    return args + [mask, scale]


def _jax(args, dtype=jnp.float32):
    return [jnp.asarray(a, dtype) if a.dtype == np.float32 and i < 10
            else jnp.asarray(a) for i, a in enumerate(args)]


def _torch(args, dtype=torch.float32):
    return [torch.from_numpy(a).to(dtype) if i < 10 else
            torch.from_numpy(a) for i, a in enumerate(args)]


def _pallas(args, dtype=jnp.float32, with_lse=False):
    from jax.experimental.pallas import tpu as pltpu
    with pltpu.force_tpu_interpret_mode():
        out = dense_attention_rpe_pallas(*_jax(args, dtype),
                                         with_lse=with_lse)
    return jax.tree_util.tree_map(np.asarray, out)


def test_plain_matches_pallas_interpret_f32():
    args = _inputs()
    ref = _pallas(args)
    got = dense_attention_rpe_reference(*_torch(args))
    assert got.shape == ref.shape and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), ref, rtol=RTOL, atol=ATOL)


def test_plain_lse_and_fully_masked_rows_match_pallas():
    args = _inputs(seed=1, masked_rows=32)
    ref_out, ref_lse = _pallas(args, with_lse=True)
    out, lse = dense_attention_rpe_reference(*_torch(args), with_lse=True)
    assert lse.shape == (4, 256) and lse.dtype == torch.float32
    np.testing.assert_allclose(out.numpy(), ref_out, rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(lse.numpy(), ref_lse, rtol=RTOL, atol=ATOL)
    # a fully masked row gives 0, not NaN
    assert np.all(out.numpy()[-32:] == 0)
    assert np.isfinite(out.numpy()).all()


def test_plain_lse_wide_k_matches_pallas():
    """K = 160 slots, ten of the CUDA kernel's 16-slot tiles, with fully
    masked rows: output and lse of the plain version vs the Pallas
    kernel's streaming pass."""
    args = _inputs(seed=12, N=128, K=160, masked_rows=8)
    ref_out, ref_lse = _pallas(args, with_lse=True)
    out, lse = dense_attention_rpe_reference(*_torch(args), with_lse=True)
    np.testing.assert_allclose(out.numpy(), ref_out, rtol=RTOL, atol=ATOL)
    valid = args[10].any(1)
    np.testing.assert_allclose(lse.numpy()[:, valid], ref_lse[:, valid],
                               rtol=RTOL, atol=ATOL)
    assert np.all(out.numpy()[-8:] == 0)


def test_plain_matches_pallas_interpret_bf16_inputs():
    """bf16 inputs, f32 math on both sides: the same rounded values go
    into the same f32 arithmetic and only the summation order differs,
    so the f32 tolerance holds."""
    args = _inputs(seed=2)
    ref = _pallas(args, dtype=jnp.bfloat16)
    got = dense_attention_rpe_reference(*_torch(args, torch.bfloat16))
    np.testing.assert_allclose(got.numpy(), ref, rtol=RTOL, atol=ATOL)


def test_plain_bf16_vs_xla_reference_in_bf16():
    """Looser tolerance: the JAX XLA expression rounds every
    intermediate (RPE sums, q*scale, softmax weights, the 16-slot
    weighted sum) to bf16, 8 bits of mantissa, where the kernel keeps
    f32. With outputs up to ~4 the two differ by up to ~5e-2."""
    args = _inputs(seed=3)
    ref = np.asarray(_rpe_xla_reference(*_jax(args, jnp.bfloat16)),
                     np.float32)
    got = dense_attention_rpe_reference(*_torch(args, torch.bfloat16))
    np.testing.assert_allclose(got.numpy(), ref, rtol=5e-2, atol=1e-1)


def test_plain_ragged_shape_vs_xla_reference():
    """N and K off the Mosaic tiling (N % 128, K % 8): reference only,
    since the Pallas kernel cannot take them."""
    args = _inputs(seed=4, N=1000, K=37, masked_rows=5)
    ref = np.asarray(_rpe_xla_reference(*_jax(args)))
    got = dense_attention_rpe_reference(*_torch(args))
    np.testing.assert_allclose(got.numpy(), ref, rtol=RTOL, atol=ATOL)


def test_wrapper_routes_cpu_tensors_to_plain_version():
    args = _torch(_inputs(seed=5))
    before = dense_attention_rpe.launches
    out, lse = dense_attention_rpe(*args, with_lse=True)
    ref_out, ref_lse = dense_attention_rpe_reference(*args, with_lse=True)
    assert torch.equal(out, ref_out) and torch.equal(lse, ref_lse)
    assert dense_attention_rpe.launches == before
    g = torch.randn(out.shape, generator=torch.Generator().manual_seed(0))
    before = dense_attention_rpe_bwd.launches
    grads = dense_attention_rpe_bwd(*args, out, lse, g)
    ref = dense_attention_rpe_bwd_reference(*args, out, lse, g)
    assert all(torch.equal(a, b) for a, b in zip(grads, ref))
    assert dense_attention_rpe_bwd.launches == before


# tests/test_pallas_attention.py's tolerance for the K3 gradients
BWD_RTOL, BWD_ATOL = 2e-3, 2e-4
GRAD_NAMES = ('dq', 'dkg', 'dvg', 'd_ef', 'dwk', 'dbk', 'dwq', 'dbq', 'dwv',
              'dbv')


@pytest.mark.parametrize('masked_rows', [0, 32])
def test_plain_backward_matches_pallas_bwd_interpret(masked_rows):
    """All ten gradients of the plain K3 vs `dense_attention_rpe_bwd_pallas`
    in interpret mode, both fed the Pallas forward's out and lse and the
    same cotangent."""
    args = _inputs(seed=8, masked_rows=masked_rows)
    g = np.random.default_rng(9).standard_normal((256, 4, 8)).astype(
        np.float32)
    out, lse = _pallas(args, with_lse=True)
    ref = dense_attention_rpe_bwd_pallas(
        *_jax(args), jnp.asarray(out), jnp.asarray(lse), jnp.asarray(g),
        interpret=True)
    got = dense_attention_rpe_bwd_reference(
        *_torch(args), torch.from_numpy(np.array(out)),
        torch.from_numpy(np.array(lse)), torch.from_numpy(g))
    for name, a, b in zip(GRAD_NAMES, got, ref):
        b = np.asarray(b)
        assert a.shape == b.shape and a.dtype == torch.float32, name
        np.testing.assert_allclose(a.numpy(), b, rtol=BWD_RTOL,
                                   atol=BWD_ATOL, err_msg=name)


@pytest.mark.parametrize('dtype', [torch.float32, torch.bfloat16])
def test_trainable_gradients_match_autograd_of_plain(dtype):
    """`dense_attention_rpe_trainable` (plain forward with lse, closed-form
    backward on the CPU) vs torch autograd through the plain forward: the
    activations in `dtype`, the RPE weights f32 as in the model. In bf16
    both sides compute in f32 from the same rounded inputs; the activation
    gradients are then rounded to bf16 (2^-8 relative), so one rounding
    step may separate them."""
    args = _torch(_inputs(seed=10, masked_rows=8))
    args = [a.to(dtype) if i in (0, 1, 2, 3) else a
            for i, a in enumerate(args)]
    w = torch.randn(256, 4, 8, generator=torch.Generator().manual_seed(11))
    grads = []
    for fn in (dense_attention_rpe_trainable, dense_attention_rpe_reference):
        leaves = [a.clone().requires_grad_() for a in args[:10]]
        (fn(*leaves, *args[10:]) * w).sum().backward()
        grads.append([t.grad for t in leaves])
    tol = (dict(rtol=BWD_RTOL, atol=BWD_ATOL) if dtype == torch.float32
           else dict(rtol=1.6e-2, atol=1e-3))
    for name, a, b in zip(GRAD_NAMES, *grads):
        assert a.dtype == b.dtype, name
        torch.testing.assert_close(a, b, **tol, msg=name)


def test_wrapper_rejects_other_devices():
    args = [a.to('meta') for a in _torch(_inputs(seed=6, N=8, K=4))]
    with pytest.raises(ValueError, match='CUDA'):
        dense_attention_rpe(*args)
