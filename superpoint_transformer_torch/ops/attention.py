"""Dense-neighbor masked softmax attention (K1), with its gradient.

Port of the TPU kernel `dense_attention_pallas` and its custom VJP
`dense_attention_pallas_trainable`
(`superpoint_transformer_tpu/ops/pallas_attention.py`), which run every
attention block of the flagship model in training, after the k/q/v
relative position encodings have been added to the gathered rows. On a
CUDA tensor `dense_attention` launches the hand-written Hopper kernel in
`csrc/dense_attention.cu` (built with nvcc for sm_90a at first use,
bound through ctypes) or raises; on a CPU tensor it runs
`dense_attention_reference`, the plain PyTorch version. The JAX
backward is XLA autodiff of the plain expression, not a kernel: its
counterpart `dense_attention_bwd` is PyTorch ops that recompute the
attention weights and write the closed-form gradients, so autograd never
runs through the plain forward. `dense_attention_trainable` ties the two
together. Layouts are the JAX ones: q [N, H, D] or per edge
[N, K, H, D], k [N, K, H, D], v [N, K, H, C/H], output [N, H, C/H] f32.
"""
import ctypes
import functools

import torch

from .cuda_build import library

__all__ = ['dense_attention', 'dense_attention_reference',
           'dense_attention_bwd', 'dense_attention_trainable']


@functools.lru_cache(maxsize=None)
def _launcher():
    fn = library('dense_attention').dense_attention_launch
    p, i = ctypes.c_void_p, ctypes.c_int
    fn.argtypes = [i] + [p] * 6 + [i] * 6 + [p]
    fn.restype = i
    return fn


def _scaled(q, scale):
    """q * scale in f32, with the query broadcast over the K slots when
    it is per node: [N, 1 or K, H, D]."""
    s = scale.to(torch.float32)
    if q.dim() == 3:
        return (q.to(torch.float32) * s[:, None, None])[:, None]
    return q.to(torch.float32) * s[:, None, None, None]


def _weights(logit, nbr_mask):
    """Masked softmax over the K slots of [N, K, H] logits; a fully
    masked row gets weight 0 everywhere."""
    m3 = nbr_mask[:, :, None]
    logit = torch.where(m3, logit, torch.full_like(logit, -1e30))
    return torch.softmax(logit, dim=1) * m3.to(logit.dtype)


def dense_attention_reference(q, k, v, nbr_mask, scale):
    """Plain PyTorch version of the kernel (the JAX package's
    `_xla_reference`). q*scale is rounded to the dtype of `k` as the
    kernel does; the math is f32."""
    qs = _scaled(q, scale).to(k.dtype).to(torch.float32)
    a = _weights((qs * k.to(torch.float32)).sum(-1), nbr_mask)
    return torch.einsum('nkh,nkhc->nhc', a, v.to(torch.float32))


def dense_attention_bwd(q, k, v, nbr_mask, scale, g, with_dscale=True):
    """Closed-form gradients of the attention w.r.t. q, k, v and scale,
    given the cotangent `g` [N, H, C/H] of the output: the counterpart of
    the JAX `_bwd`, which differentiates the plain expression (without
    the forward's rounding of q*scale). Recomputes the attention weights
    a; with e = a * (g.v - sum_c g*out) the logit gradient,
    dv = a g, dk = e q*scale, dq = e k * scale (summed over the slots for
    a per-node q) and dscale = sum e <q, k>. Math in f32; dq, dk, dv come
    out in the dtypes of q, k, v and dscale in f32 (None unless
    `with_dscale`)."""
    f32 = torch.float32
    kf, vf, gf = k.to(f32), v.to(f32), g.to(f32)
    qs = _scaled(q, scale)                                # [N, 1|K, H, D]
    a = _weights((qs * kf).sum(-1), nbr_mask)             # [N, K, H]
    out = torch.einsum('nkh,nkhc->nhc', a, vf)
    dv = a[..., None] * gf[:, None]                       # [N, K, H, C/H]
    dp = torch.einsum('nhc,nkhc->nkh', gf, vf)
    e = a * (dp - (gf * out).sum(-1)[:, None])            # [N, K, H]
    dqs = e[..., None] * kf                               # [N, K, H, D]
    dk = e[..., None] * qs
    if q.dim() == 3:
        dqs = dqs.sum(1)
    s = scale.to(f32).reshape((-1,) + (1,) * (dqs.dim() - 1))
    dscale = None
    if with_dscale:
        dscale = (dqs * q.to(f32)).reshape(q.shape[0], -1).sum(1)
    return (dqs * s).to(q.dtype), dk.to(k.dtype), dv.to(v.dtype), dscale


def _check(name, t, dtype, shape, device):
    if t.device != device:
        raise ValueError(f'{name} is on {t.device}, expected {device}')
    if t.dtype != dtype:
        raise ValueError(f'{name} has dtype {t.dtype}, expected {dtype}')
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f'{name} has shape {tuple(t.shape)}, '
                         f'expected {tuple(shape)}')
    if not t.is_contiguous():
        raise ValueError(f'dense_attention: {name} must be contiguous')


def dense_attention(q, k, v, nbr_mask, scale):
    """Fused masked-softmax attention over K dense neighbor slots.

    :param q: [N, H, D] node queries, or [N, K, H, D] per-edge queries
        (q RPE)
    :param k: [N, K, H, D] keys
    :param v: [N, K, H, C/H] values
    :param nbr_mask: [N, K] bool slot validity
    :param scale: [N] f32 per-node softmax scale
    :return: [N, H, C/H] f32

    q, k and v share one dtype (f32 or bf16) and are contiguous; the math
    is f32 with q*scale rounded to that dtype. CPU tensors run the plain
    version; CUDA tensors launch the kernel or raise.
    """
    dev = k.device
    if dev.type not in ('cpu', 'cuda'):
        raise ValueError(f'dense_attention: tensors on {dev}; the kernel '
                         'runs on a CUDA device')
    if k.dim() != 4 or v.dim() != 4 or q.dim() not in (3, 4):
        raise ValueError('dense_attention: k and v must be 4-D, q 3-D or '
                         '4-D')
    # the same layout rules on both devices, so that the CPU tests catch
    # what the kernel would refuse
    N, K, H, D = k.shape
    CH = v.shape[3]
    dt = k.dtype
    if dt not in (torch.float32, torch.bfloat16):
        raise ValueError(f'dense_attention: dtype {dt} unsupported '
                         '(float32 or bfloat16)')
    _check('q', q, dt, (N, H, D) if q.dim() == 3 else (N, K, H, D), dev)
    _check('k', k, dt, (N, K, H, D), dev)
    _check('v', v, dt, (N, K, H, CH), dev)
    _check('nbr_mask', nbr_mask, torch.bool, (N, K), dev)
    _check('scale', scale, torch.float32, (N,), dev)
    if dev.type == 'cpu':
        return dense_attention_reference(q, k, v, nbr_mask, scale)

    if dev.index != torch.cuda.current_device():
        raise ValueError(f'dense_attention: tensors on {dev}, not on the '
                         'current CUDA device')
    C = H * CH
    if D > 32 or D & (D - 1) or H * D > 128 or C > 128:
        raise ValueError(
            f'dense_attention: kernel needs D a power of two <= 32, '
            f'H*D <= 128 and H*C/H <= 128 (got D={D}, H*D={H * D}, C={C})')
    out = torch.empty((N, H, CH), dtype=torch.float32, device=dev)
    rc = _launcher()(
        int(dt == torch.bfloat16), q.data_ptr(), k.data_ptr(), v.data_ptr(),
        nbr_mask.data_ptr(), scale.data_ptr(), out.data_ptr(), N, K, H, D, C,
        int(q.dim() == 4), torch.cuda.current_stream(dev).cuda_stream)
    if rc != 0:
        raise RuntimeError(
            f'dense_attention: kernel launch failed with CUDA error {rc}')
    dense_attention.launches += 1
    return out


# kernel launches since the last reset (plain CPU calls are not counted)
dense_attention.launches = 0


class _DenseAttention(torch.autograd.Function):

    @staticmethod
    def forward(ctx, q, k, v, nbr_mask, scale):
        ctx.save_for_backward(q, k, v, nbr_mask, scale)
        return dense_attention(q, k, v, nbr_mask, scale)

    @staticmethod
    def backward(ctx, g):
        q, k, v, nbr_mask, scale = ctx.saved_tensors
        dq, dk, dv, dscale = dense_attention_bwd(
            q, k, v, nbr_mask, scale, g, with_dscale=ctx.needs_input_grad[4])
        return dq, dk, dv, None, dscale


def dense_attention_trainable(q, k, v, nbr_mask, scale):
    """`dense_attention` with a gradient (the JAX package's
    `dense_attention_pallas_trainable`): the forward is the kernel on
    CUDA tensors, the backward `dense_attention_bwd`. Gradients flow to
    q, k, v and scale."""
    return _DenseAttention.apply(q, k, v, nbr_mask, scale)
