"""The CUDA kernels of the port vs their plain PyTorch versions, on the
card: K1 (`dense_attention`) and its autograd function, K2
(`dense_attention_rpe`) and K3 (`dense_attention_rpe_bwd`). Every test
here is marked `cuda` and skips without a CUDA device. The file imports neither jax nor the JAX package, so it runs on
a machine without them:

    python -m pytest --noconftest tests/test_torch_cuda.py
"""
import numpy as np
import pytest
import torch

from superpoint_transformer_torch.ops.attention import (
    dense_attention, dense_attention_reference, dense_attention_trainable)
from superpoint_transformer_torch.ops.attention_rpe import (
    dense_attention_rpe, dense_attention_rpe_bwd,
    dense_attention_rpe_bwd_reference, dense_attention_rpe_reference,
    dense_attention_rpe_trainable)

# the JAX kernel tests' own tolerances: both sides compute in f32 from
# the same inputs, in another summation order
RTOL, ATOL = 2e-4, 2e-5              # K2
K1_TOL = dict(rtol=3e-5, atol=3e-5)
K3_TOL = dict(rtol=2e-3, atol=2e-4)
# gradients written in bf16 by both sides from the same f32 math: one
# rounding step (2^-8 relative) may separate them
BF16_TOL = dict(rtol=1.6e-2, atol=1e-3)


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip('needs an NVIDIA GPU: the CUDA kernel has no CPU mode')
    return torch.device('cuda', torch.cuda.current_device())


def _inputs(dev, dtype, N, K, H, D, C, De, masked_rows, seed=0):
    rng = np.random.default_rng(seed)

    def mk(*s, scale=1.0):
        return torch.from_numpy(
            rng.standard_normal(s).astype(np.float32) * scale).to(dev, dtype)

    args = [mk(N, H, D), mk(N, K, H * D), mk(N, K, C), mk(N, K, De),
            mk(De, H * D, scale=0.3), mk(H * D, scale=0.1),
            mk(De, H * D, scale=0.3), mk(H * D, scale=0.1),
            mk(De, C, scale=0.3), mk(C, scale=0.1)]
    mask = rng.random((N, K)) < 0.7
    mask[:, 0] = True
    mask[N - masked_rows:] = False
    scale = (rng.random(N) * 0.5 + 0.2).astype(np.float32)
    return args + [torch.from_numpy(mask).to(dev),
                   torch.from_numpy(scale).to(dev)]


@pytest.mark.cuda
@pytest.mark.parametrize('dtype', [torch.float32, torch.bfloat16])
@pytest.mark.parametrize('shape', [
    dict(N=1000, K=37, H=4, D=4, C=32, De=8, masked_rows=7),
    dict(N=10_240, K=48, H=16, D=4, C=64, De=32, masked_rows=100)],
    ids=['ragged', 'flagship'])
def test_kernel_matches_plain(cuda_device, dtype, shape):
    args = _inputs(cuda_device, dtype, **shape)
    before = dense_attention_rpe.launches
    out, lse = dense_attention_rpe(*args, with_lse=True)
    ref, ref_lse = dense_attention_rpe_reference(*args, with_lse=True)
    torch.cuda.synchronize()
    assert dense_attention_rpe.launches == before + 1
    torch.testing.assert_close(out, ref, rtol=RTOL, atol=ATOL)
    valid = args[10].any(1)
    torch.testing.assert_close(lse[:, valid], ref_lse[:, valid],
                               rtol=RTOL, atol=ATOL)
    assert torch.all(out[~valid] == 0)


@pytest.mark.cuda
def test_kernel_reads_column_blocks_of_a_gathered_table(cuda_device):
    """The attention block hands the kernel the k and v column blocks of
    one gathered [N, K, H*D + C] table, without copies."""
    args = _inputs(cuda_device, torch.bfloat16, N=512, K=16, H=4, D=4,
                   C=32, De=8, masked_rows=3)
    kv = torch.cat([args[1], args[2]], 2)
    args_view = list(args)
    args_view[1], args_view[2] = kv[..., :16], kv[..., 16:]
    torch.testing.assert_close(dense_attention_rpe(*args_view),
                               dense_attention_rpe(*args), rtol=0, atol=0)


@pytest.mark.cuda
def test_kernel_rejects_what_it_cannot_take(cuda_device):
    args = _inputs(cuda_device, torch.float32, N=64, K=8, H=4, D=3, C=12,
                   De=4, masked_rows=0)
    with pytest.raises(ValueError, match='power of two'):
        dense_attention_rpe(*args)
    args = _inputs(cuda_device, torch.float16, N=64, K=8, H=4, D=4, C=16,
                   De=4, masked_rows=0)
    with pytest.raises(ValueError, match='dtype'):
        dense_attention_rpe(*args)


def _k1_inputs(dev, dtype, N, K, H, D, CH, q_per_edge, masked_rows, seed=0):
    rng = np.random.default_rng(seed)

    def mk(*s):
        return torch.from_numpy(
            rng.standard_normal(s).astype(np.float32)).to(dev, dtype)

    q = mk(N, K, H, D) if q_per_edge else mk(N, H, D)
    mask = rng.random((N, K)) < 0.7
    mask[:, 0] = True
    mask[N - masked_rows:] = False
    scale = (rng.random(N) * 0.5 + 0.2).astype(np.float32)
    return [q, mk(N, K, H, D), mk(N, K, H, CH),
            torch.from_numpy(mask).to(dev), torch.from_numpy(scale).to(dev)]


K1_SHAPES = [dict(N=1000, K=37, H=4, D=4, CH=8, masked_rows=7),
             dict(N=5120, K=48, H=16, D=4, CH=4, masked_rows=100)]


@pytest.mark.cuda
@pytest.mark.parametrize('dtype', [torch.float32, torch.bfloat16])
@pytest.mark.parametrize('q_per_edge', [False, True],
                         ids=['q_node', 'q_edge'])
@pytest.mark.parametrize('shape', K1_SHAPES, ids=['ragged', 'flagship'])
def test_k1_kernel_matches_plain(cuda_device, dtype, q_per_edge, shape):
    args = _k1_inputs(cuda_device, dtype, q_per_edge=q_per_edge, **shape)
    before = dense_attention.launches
    out = dense_attention(*args)
    ref = dense_attention_reference(*args)
    torch.cuda.synchronize()
    assert dense_attention.launches == before + 1
    torch.testing.assert_close(out, ref, **K1_TOL)
    assert torch.all(out[~args[3].any(1)] == 0)


@pytest.mark.cuda
@pytest.mark.parametrize('dtype', [torch.float32, torch.bfloat16])
@pytest.mark.parametrize('q_per_edge', [False, True],
                         ids=['q_node', 'q_edge'])
def test_k1_backward_matches_autograd_of_plain(cuda_device, dtype,
                                               q_per_edge):
    """The autograd function (kernel forward, closed-form backward) vs
    autograd through the plain version on the same values in f32 (the
    closed form, like the JAX backward, differentiates the attention
    without the forward's rounding of q*scale), rounded to `dtype`."""
    args = _k1_inputs(cuda_device, dtype, q_per_edge=q_per_edge,
                      **K1_SHAPES[1])
    w = torch.randn(args[1].shape[0], 16, 4, device=cuda_device)
    grads = []
    for fn, cast in ((dense_attention_trainable, dtype),
                     (dense_attention_reference, torch.float32)):
        q, k, v = (a.to(cast, copy=True).requires_grad_() for a in args[:3])
        scale = args[4].clone().requires_grad_()
        (fn(q, k, v, args[3], scale) * w).sum().backward()
        grads.append([t.grad for t in (q, k, v, scale)])
    for name, a, b in zip(('dq', 'dk', 'dv', 'dscale'), *grads):
        tol = BF16_TOL if a.dtype == torch.bfloat16 else K1_TOL
        torch.testing.assert_close(a, b.to(a.dtype), **tol, msg=name)


K3_GRADS = ('dq', 'dkg', 'dvg', 'd_ef', 'dwk', 'dbk', 'dwq', 'dbq', 'dwv',
            'dbv')


@pytest.mark.cuda
@pytest.mark.parametrize('shape', [
    dict(N=1000, K=37, H=4, D=4, C=32, De=8, masked_rows=7),
    dict(N=5120, K=48, H=16, D=4, C=64, De=32, masked_rows=100)],
    ids=['ragged', 'flagship'])
def test_k3_kernel_matches_autograd_of_plain(cuda_device, shape):
    """K3's ten gradients vs autograd through K2's plain version (f32);
    the weight gradients are the same in two runs (no atomics)."""
    args = _inputs(cuda_device, torch.float32, **shape)
    H, C = shape['H'], shape['C']
    g = torch.randn(shape['N'], H, C // H, device=cuda_device)
    out, lse = dense_attention_rpe(*args, with_lse=True)
    before = dense_attention_rpe_bwd.launches
    grads = dense_attention_rpe_bwd(*args, out, lse, g)
    again = dense_attention_rpe_bwd(*args, out, lse, g)
    assert dense_attention_rpe_bwd.launches == before + 2
    leaves = [a.clone().requires_grad_() for a in args[:10]]
    (dense_attention_rpe_reference(*leaves, *args[10:]) * g).sum().backward()
    for name, a, t in zip(K3_GRADS, grads, leaves):
        torch.testing.assert_close(a, t.grad, **K3_TOL, msg=name)
    for name, a, b in zip(K3_GRADS[4:], grads[4:], again[4:]):
        assert torch.equal(a, b), name


@pytest.mark.cuda
def test_k3_kernel_matches_plain_bf16(cuda_device):
    args = _inputs(cuda_device, torch.bfloat16, N=2048, K=48, H=16, D=4,
                   C=64, De=32, masked_rows=64)
    g = torch.randn(2048, 16, 4, device=cuda_device)
    out, lse = dense_attention_rpe(*args, with_lse=True)
    grads = dense_attention_rpe_bwd(*args, out, lse, g)
    ref = dense_attention_rpe_bwd_reference(*args, out, lse, g)
    for i, (name, a, b) in enumerate(zip(K3_GRADS, grads, ref)):
        assert a.dtype == b.dtype, name
        torch.testing.assert_close(a, b, **(BF16_TOL if i < 4 else K3_TOL),
                                   msg=name)


@pytest.mark.cuda
def test_rpe_trainable_launches_k2_and_k3(cuda_device):
    args = _inputs(cuda_device, torch.float32, N=512, K=16, H=4, D=4, C=32,
                   De=8, masked_rows=3)
    leaves = [a.clone().requires_grad_() for a in args[:10]]
    k2, k3 = dense_attention_rpe.launches, dense_attention_rpe_bwd.launches
    dense_attention_rpe_trainable(*leaves, *args[10:]).sum().backward()
    assert dense_attention_rpe.launches == k2 + 1
    assert dense_attention_rpe_bwd.launches == k3 + 1
    ref = [a.clone().requires_grad_() for a in args[:10]]
    dense_attention_rpe_reference(*ref, *args[10:]).sum().backward()
    for name, a, b in zip(K3_GRADS, leaves, ref):
        torch.testing.assert_close(a.grad, b.grad, **K3_TOL, msg=name)


@pytest.mark.cuda
def test_k1_and_k3_reject_what_they_cannot_take(cuda_device):
    args = _k1_inputs(cuda_device, torch.float32, N=64, K=8, H=4, D=3, CH=4,
                      q_per_edge=False, masked_rows=0)
    with pytest.raises(ValueError, match='power of two'):
        dense_attention(*args)
    args = _inputs(cuda_device, torch.float32, N=64, K=8, H=4, D=4, C=12,
                   De=4, masked_rows=0)
    g = torch.zeros(64, 4, 3, device=cuda_device)
    out, lse = dense_attention_rpe(*args, with_lse=True)
    with pytest.raises(ValueError, match='power of two'):
        dense_attention_rpe_bwd(*args, out, lse, g)
