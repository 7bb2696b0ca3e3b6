"""The port's streaming RPE attention (plain version of the K2 kernel,
superpoint_transformer_torch/ops/attention_rpe.py) vs the JAX Pallas
kernel `dense_attention_rpe_pallas` run in TPU interpret mode, as
tests/test_pallas_attention.py runs it on the CPU, and vs the JAX
package's `_rpe_xla_reference`. The CUDA kernel itself is checked
against the plain version by tests/test_torch_cuda.py (on the card) and
by chip_smoke.py."""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from superpoint_transformer_tpu.ops.pallas_attention import (
    dense_attention_rpe_pallas, _rpe_xla_reference)
from superpoint_transformer_torch.ops.attention_rpe import (
    dense_attention_rpe, dense_attention_rpe_reference)

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


def test_wrapper_rejects_other_devices():
    args = [a.to('meta') for a in _torch(_inputs(seed=6, N=8, K=4))]
    with pytest.raises(ValueError, match='CUDA'):
        dense_attention_rpe(*args)
