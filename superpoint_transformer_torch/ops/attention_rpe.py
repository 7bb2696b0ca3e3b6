"""Streaming dense-neighbor attention with in-kernel RPE, and its
backward.

Port of the TPU kernels `dense_attention_rpe_pallas` (K2, which serves
every attention block of the flagship model at inference) and
`dense_attention_rpe_bwd_pallas` (K3, its one-pass backward from the
saved log-sum-exp), both in
`superpoint_transformer_tpu/ops/pallas_attention.py`. On CUDA tensors
`dense_attention_rpe` and `dense_attention_rpe_bwd` launch the
hand-written Hopper kernels in `csrc/dense_attention_rpe.cu` and
`csrc/dense_attention_rpe_bwd.cu` (built with nvcc for sm_90a at first
use, bound through ctypes) or raise; on CPU tensors they run
`dense_attention_rpe_reference` and `dense_attention_rpe_bwd_reference`,
the plain PyTorch versions of the same functions.
`dense_attention_rpe_trainable` ties the two into an autograd function.
The public layouts are the JAX ones: gathered keys [N, K, H*D], gathered
values [N, K, C], output [N, H, C/H] f32, lse [H, N] f32.
"""
import ctypes
import functools

import torch

from ..utils.flops import count_contraction, opaque
from .cost import contraction_flops
from .cuda_build import library

__all__ = ['dense_attention_rpe', 'dense_attention_rpe_reference',
           'dense_attention_rpe_bwd', 'dense_attention_rpe_bwd_reference',
           'dense_attention_rpe_trainable']


@functools.lru_cache(maxsize=None)
def _launcher():
    fn = library('dense_attention_rpe').dense_attention_rpe_launch
    p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    fn.argtypes = ([i, p, p, ll, p, ll] + [p] * 11 + [i] * 6 + [p])
    fn.restype = i
    return fn


@functools.lru_cache(maxsize=None)
def _bwd_launcher():
    lib = library('dense_attention_rpe_bwd')
    p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    lib.dense_attention_rpe_bwd_blocks.argtypes = [i] * 7
    lib.dense_attention_rpe_bwd_blocks.restype = i
    fn = lib.dense_attention_rpe_bwd_launch
    fn.argtypes = ([i, p, p, ll, p, ll] + [p] * 18 + [i] * 6 + [p])
    fn.restype = i
    return lib.dense_attention_rpe_bwd_blocks, fn


def _rpe_terms(q_node, k_nodes_g, v_nodes_g, ef, wk, bk, wq, bq, wv, bv):
    """Inputs rounded to the dtype of `k_nodes_g`, in f32 (f64 for f64
    inputs, a reference for the kernels' own rounding): the edge
    features e and the RPE-augmented k [N, K, H*D], q [N, K, H*D] and
    v [N, K, C], as both kernels compute them."""
    N, DH = q_node.shape[0], k_nodes_g.shape[2]
    dt = k_nodes_g.dtype
    ct = torch.promote_types(dt, torch.float32)

    def c(t):
        return t.to(dt).to(ct)

    e = c(ef)
    k = c(k_nodes_g) + e @ c(wk) + c(bk)
    q = c(q_node).reshape(N, 1, DH) + e @ c(wq) + c(bq)
    v = c(v_nodes_g) + e @ c(wv) + c(bv)
    return e, k, q, v


def _masked_logits(q, k, nbr_mask, scale, H):
    N, K, DH = k.shape
    # <q, k> over each head's D channels: counted as a contraction
    qk = count_contraction((q * k).reshape(N, K, H, DH // H).sum(-1),
                           2 * N * K * DH)
    logit = qk * scale.to(torch.float32)[:, None, None]   # [N, K, H]
    return torch.where(nbr_mask[:, :, None], logit,
                       torch.full_like(logit, -1e30))


def dense_attention_rpe_reference(q_node, k_nodes_g, v_nodes_g, ef, wk,
                                  bk, wq, bq, wv, bv, nbr_mask, scale,
                                  with_lse=False):
    """Plain PyTorch version of the K2 kernel (the JAX package's
    `_rpe_xla_reference`, plus the kernel's lse). Inputs are rounded to
    the dtype of `k_nodes_g` and the math runs in f32, as in the kernel
    (in f64 for f64 inputs: the card tests' reference for K3)."""
    N, K, DH = k_nodes_g.shape
    H, C = q_node.shape[1], v_nodes_g.shape[2]
    _, k, q, v = _rpe_terms(q_node, k_nodes_g, v_nodes_g, ef, wk, bk, wq,
                            bq, wv, bv)
    logit = _masked_logits(q, k, nbr_mask, scale, H)
    m3 = nbr_mask[:, :, None]
    mx = logit.amax(1, keepdim=True)
    p = torch.exp(logit - mx) * m3.to(torch.float32)
    denom = p.sum(1).clamp(min=1e-30)                     # [N, H]
    out = torch.einsum('nkh,nkhc->nhc', p,
                       v.reshape(N, K, H, C // H)) / denom[:, :, None]
    if with_lse:
        return out, (mx[:, 0] + torch.log(denom)).t().contiguous()
    return out


def _rpe_bwd_rows(q_node, k_nodes_g, v_nodes_g, ef, wk, bk, wq, bq, wv, bv,
                  nbr_mask, scale, out, lse, g):
    """The per-slot terms of K3's plain version, in f32 (f64 for f64
    inputs): the edge features e [N, K, De] rounded to the dtype of
    `k_nodes_g`, and the gradient rows dk_full, dq_full [N, K, H*D] and
    dv [N, K, C] that the kernel stages, G = [dk_full | dq_full | dv]."""
    N, K, DH = k_nodes_g.shape
    H, D = q_node.shape[1], q_node.shape[2]
    C = v_nodes_g.shape[2]
    ct = torch.promote_types(k_nodes_g.dtype, torch.float32)
    e, k, q, v = _rpe_terms(q_node, k_nodes_g, v_nodes_g, ef, wk, bk, wq,
                            bq, wv, bv)
    logit = _masked_logits(q, k, nbr_mask, scale, H)
    p = torch.where(nbr_mask[:, :, None],
                    torch.exp(logit - lse.to(ct).t()[:, None, :]),
                    torch.zeros_like(logit))              # [N, K, H]
    g = g.to(ct).reshape(N, H, C // H)
    # the softmax row correction, outside the kernel as in JAX
    delta = (g * out.to(ct).reshape(N, H, C // H)).sum(-1)   # [N, H]
    dv = (p[..., None] * g[:, None]).reshape(N, K, C)
    dp = (g[:, None] * v.reshape(N, K, H, C // H)).sum(-1)    # [N, K, H]
    e_h = p * (dp - delta[:, None]) * scale.to(ct)[:, None, None]
    e_d = e_h.repeat_interleave(D, dim=2)                 # [N, K, H*D]
    return e, e_d * q, e_d * k, dv


def dense_attention_rpe_bwd_reference(q_node, k_nodes_g, v_nodes_g, ef,
                                      wk, bk, wq, bq, wv, bv, nbr_mask,
                                      scale, out, lse, g):
    """Plain PyTorch version of the K3 kernel: the closed-form gradients
    of `dense_attention_rpe` from its output `out` [N, H, C/H] and `lse`
    [H, N] and the cotangent `g` of `out`, in the order (dq, dkg, dvg,
    d_ef, dwk, dbk, dwq, dbq, dwv, dbv). Per-edge and per-node gradients
    come out in the dtype of `k_nodes_g`, weight and bias gradients in
    f32, as from the kernel (all in f64 for f64 inputs)."""
    N, K, _ = k_nodes_g.shape
    H, D = q_node.shape[1], q_node.shape[2]
    De = ef.shape[2]
    dt = k_nodes_g.dtype
    ct = torch.promote_types(dt, torch.float32)
    e, dk_full, dq_full, dv = _rpe_bwd_rows(
        q_node, k_nodes_g, v_nodes_g, ef, wk, bk, wq, bq, wv, bv, nbr_mask,
        scale, out, lse, g)
    d_ef = dk_full @ wk.to(dt).to(ct).t() + dq_full @ wq.to(dt).to(ct).t() \
        + dv @ wv.to(dt).to(ct).t()
    ef2 = e.reshape(N * K, De).t()

    def wgrad(d):
        return ef2 @ d.reshape(N * K, -1), d.sum((0, 1))

    dwk, dbk = wgrad(dk_full)
    dwq, dbq = wgrad(dq_full)
    dwv, dbv = wgrad(dv)
    return (dq_full.sum(1).reshape(N, H, D).to(dt), dk_full.to(dt),
            dv.to(dt), d_ef.to(dt), dwk, dbk, dwq, dbq, dwv, dbv)


def _check(name, t, dtype, shape, device):
    if t.device != device:
        raise ValueError(f'{name} is on {t.device}, expected {device}')
    if t.dtype != dtype:
        raise ValueError(f'{name} has dtype {t.dtype}, expected {dtype}')
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f'{name} has shape {tuple(t.shape)}, '
                         f'expected {tuple(shape)}')


def _prepare(fn, q_node, kg, vg, ef, wk, bk, wq, bq, wv, bv, nbr_mask,
             scale):
    """The layout checks both kernels share, on both devices so that the
    CPU tests catch what a kernel would refuse. Returns the inputs with
    q_node, ef and the weights cast to the dtype of `kg`, and the sizes
    (N, K, H, D, C, De)."""
    dev = kg.device
    if dev.type not in ('cpu', 'cuda'):
        raise ValueError(f'{fn}: tensors on {dev}; the kernel runs on a '
                         'CUDA device')
    if kg.dim() != 3 or vg.dim() != 3 or q_node.dim() != 3 \
            or ef.dim() != 3:
        raise ValueError(f'{fn}: q_node, k_nodes_g, v_nodes_g and ef must '
                         'be 3-D')
    N, K, DH = kg.shape
    H, D = q_node.shape[1], q_node.shape[2]
    C, De = vg.shape[2], ef.shape[2]
    dt = kg.dtype
    if dt not in (torch.float32, torch.bfloat16):
        raise ValueError(f'{fn}: dtype {dt} unsupported (float32 or '
                         'bfloat16)')
    if DH != H * D or C % H != 0:
        raise ValueError(f'{fn}: H*D={H * D} vs {DH}, C={C} vs H={H}')
    q_node, ef = q_node.to(dt), ef.to(dt)
    wk, bk, wq, bq, wv, bv = (t.to(dt) for t in (wk, bk, wq, bq, wv, bv))
    _check('q_node', q_node, dt, (N, H, D), dev)
    _check('v_nodes_g', vg, dt, (N, K, C), dev)
    _check('ef', ef, dt, (N, K, De), dev)
    for name, t, shape in (('wk', wk, (De, DH)), ('bk', bk, (DH,)),
                           ('wq', wq, (De, DH)), ('bq', bq, (DH,)),
                           ('wv', wv, (De, C)), ('bv', bv, (C,))):
        _check(name, t, dt, shape, dev)
    _check('nbr_mask', nbr_mask, torch.bool, (N, K), dev)
    _check('scale', scale, torch.float32, (N,), dev)
    for name, t in (('q_node', q_node), ('ef', ef), ('wk', wk),
                    ('bk', bk), ('wq', wq), ('bq', bq), ('wv', wv),
                    ('bv', bv), ('nbr_mask', nbr_mask),
                    ('scale', scale)):
        if not t.is_contiguous():
            raise ValueError(f'{fn}: {name} must be contiguous')
    ldk, ldv = kg.stride(1), vg.stride(1)
    if kg.stride() != (K * ldk, ldk, 1) or vg.stride() != (K * ldv, ldv, 1):
        raise ValueError(
            f'{fn}: k_nodes_g / v_nodes_g need a contiguous last axis and '
            f'[N, K] row layout (strides {kg.stride()}, {vg.stride()})')
    if dev.type == 'cuda':
        if dev.index != torch.cuda.current_device():
            raise ValueError(f'{fn}: tensors on {dev}, not on the current '
                             'CUDA device')
        if D > 32 or D & (D - 1) or DH > 128 or C > 128:
            raise ValueError(
                f'{fn}: kernel needs D a power of two <= 32, H*D <= 128 '
                f'and C <= 128 (got D={D}, H*D={DH}, C={C})')
    return ((q_node, kg, vg, ef, wk, bk, wq, bq, wv, bv, nbr_mask, scale),
            (N, K, H, D, C, De))


def dense_attention_rpe(q_node, k_nodes_g, v_nodes_g, ef, wk, bk, wq, bq,
                        wv, bv, nbr_mask, scale, with_lse=False):
    """Masked softmax attention over K neighbor slots, with the k/q/v
    relative position encodings computed from the edge features inside
    the kernel.

    :param q_node: [N, H, D] node queries
    :param k_nodes_g: [N, K, H*D] gathered neighbor keys; its last axis
        must be contiguous (a column slice of a gathered [N, K, *] row
        table is accepted as is)
    :param v_nodes_g: [N, K, C] gathered neighbor values, same dtype
        and the same layout rule as `k_nodes_g`
    :param ef: [N, K, De] edge features
    :param wk, bk, wq, bq: [De, H*D], [H*D] key / query RPE projections
    :param wv, bv: [De, C], [C] value RPE projection
    :param nbr_mask: [N, K] bool slot validity
    :param scale: [N] f32 per-node softmax scale
    :return: [N, H, C/H] f32, and [H, N] f32 lse when `with_lse`

    q_node, ef and the weights are cast to the dtype of `k_nodes_g`
    (f32 or bf16); the math is f32. CPU tensors run the plain version;
    CUDA tensors launch the kernel or raise.
    """
    args, (N, K, H, D, C, De) = _prepare(
        'dense_attention_rpe', q_node, k_nodes_g, v_nodes_g, ef, wk, bk, wq,
        bq, wv, bv, nbr_mask, scale)
    flops = contraction_flops('K2', N, K, H, D, C, De)
    if k_nodes_g.device.type == 'cpu':
        with opaque(flops):
            return dense_attention_rpe_reference(*args, with_lse=with_lse)

    q_node, kg, vg, ef, wk, bk, wq, bq, wv, bv, nbr_mask, scale = args
    dev = kg.device
    esz = kg.element_size()
    rows = (H * D, C, De, kg.stride(1), vg.stride(1))
    if H > 32:
        raise ValueError('dense_attention_rpe: kernel needs H <= 32 heads '
                         f'(got {H})')
    if De > 64 or any(r * esz % 16 for r in rows) \
            or any(t.data_ptr() % 16 for t in (q_node, kg, vg, ef)):
        raise ValueError(
            'dense_attention_rpe: the kernel copies 16-byte chunks and runs '
            'its projections in k-steps of 16 up to De = 64, so it needs '
            'De <= 64, 16-byte aligned q_node, k_nodes_g, v_nodes_g and ef, '
            'and H*D, C, De and the slot strides of k_nodes_g / v_nodes_g '
            f'in multiples of 16 bytes (got H*D, C, De, strides = {rows}, '
            f'{esz}-byte elements)')
    out = torch.empty((N, C), dtype=torch.float32, device=dev)
    lse = torch.empty((H, N), dtype=torch.float32, device=dev) \
        if with_lse else None
    with opaque(flops):
        rc = _launcher()(
            int(kg.dtype == torch.bfloat16), q_node.data_ptr(), kg.data_ptr(),
            kg.stride(1), vg.data_ptr(), vg.stride(1), ef.data_ptr(),
            wk.data_ptr(), bk.data_ptr(), wq.data_ptr(), bq.data_ptr(),
            wv.data_ptr(), bv.data_ptr(), nbr_mask.data_ptr(),
            scale.data_ptr(), out.data_ptr(),
            None if lse is None else lse.data_ptr(), N, K, H, D, C, De,
            torch.cuda.current_stream(dev).cuda_stream)
    if rc != 0:
        raise RuntimeError(
            f'dense_attention_rpe: kernel launch failed with CUDA error {rc}')
    dense_attention_rpe.launches += 1
    out = out.view(N, H, C // H)
    return (out, lse) if with_lse else out


# kernel launches since the last reset (plain CPU calls are not counted)
dense_attention_rpe.launches = 0


def dense_attention_rpe_bwd(q_node, k_nodes_g, v_nodes_g, ef, wk, bk, wq,
                            bq, wv, bv, nbr_mask, scale, out, lse, g):
    """Gradients of `dense_attention_rpe` in one streaming pass over the
    neighbor slots.

    Takes the forward's inputs (same layout rules), its output `out`
    [N, H, C/H] and `lse` [H, N] (`with_lse=True`), and the cotangent `g`
    [N, H, C/H] of `out`. Returns (dq [N, H, D], dkg [N, K, H*D],
    dvg [N, K, C], d_ef [N, K, De]) in the dtype of `k_nodes_g`, then
    (dwk, dbk, dwq, dbq, dwv, dbv) in f32. The weight and bias gradients
    are the same in every run on a given card (no atomics). CPU tensors
    run the plain version; CUDA tensors launch the kernel or raise.
    """
    args, (N, K, H, D, C, De) = _prepare(
        'dense_attention_rpe_bwd', q_node, k_nodes_g, v_nodes_g, ef, wk, bk,
        wq, bq, wv, bv, nbr_mask, scale)
    dev = k_nodes_g.device
    out = out.to(torch.float32)
    g = g.to(torch.float32).contiguous()
    _check('out', out, torch.float32, (N, H, C // H), dev)
    _check('g', g, torch.float32, (N, H, C // H), dev)
    _check('lse', lse, torch.float32, (H, N), dev)
    if not lse.is_contiguous():
        raise ValueError('dense_attention_rpe_bwd: lse must be contiguous')
    flops = contraction_flops('K3', N, K, H, D, C, De)
    if dev.type == 'cpu':
        with opaque(flops):
            return dense_attention_rpe_bwd_reference(*args, out, lse, g)

    q_node, kg, vg, ef, wk, bk, wq, bq, wv, bv, nbr_mask, scale = args
    DH, W = H * D, 2 * H * D + C
    CH = C // H
    bf16 = kg.dtype == torch.bfloat16
    if CH > 32 or CH & (CH - 1):
        raise ValueError('dense_attention_rpe_bwd: kernel needs C/H a power '
                         f'of two <= 32 (got C/H={CH})')
    if not bf16 and -(-(De + 1) // 8) * W > 1024:
        raise ValueError(
            'dense_attention_rpe_bwd: the float32 kernel needs '
            f'ceil((De+1)/8) * (2*H*D + C) <= 1024 (got De={De}, '
            f'2*H*D + C={W})')
    if bf16 and De > 64:
        raise ValueError('dense_attention_rpe_bwd: the bfloat16 kernel runs '
                         'its projections in k-steps of 16 up to De = 64 '
                         f'(got De={De})')
    blocks_fn, launch = _bwd_launcher()
    blocks = blocks_fn(int(bf16), N, K, H, D, C, De)
    if blocks < 0:
        raise ValueError(
            'dense_attention_rpe_bwd: the bfloat16 kernel\'s tiles do not '
            f'fit in shared memory at H={H}, D={D}, C={C}, De={De}')
    # the softmax row correction, outside the kernel as in JAX
    delta = (g * out).sum(-1).t().contiguous()            # [H, N]
    dt = kg.dtype
    dq = torch.empty((N, DH), dtype=dt, device=dev)
    dkg = torch.empty((N, K, DH), dtype=dt, device=dev)
    dvg = torch.empty((N, K, C), dtype=dt, device=dev)
    d_ef = torch.empty((N, K, De), dtype=dt, device=dev)
    # the block partials of the weight gradients: f64 for f32 inputs,
    # whose kernel sums them in f64
    partial = torch.empty(
        (max(blocks, 1), De + 1, W), device=dev,
        dtype=torch.float32 if bf16 else torch.float64)
    dw = torch.zeros((De + 1, W), dtype=torch.float32, device=dev)
    with opaque(flops):
        rc = launch(
            int(bf16), q_node.data_ptr(), kg.data_ptr(),
            kg.stride(1), vg.data_ptr(), vg.stride(1), ef.data_ptr(),
            wk.data_ptr(), bk.data_ptr(), wq.data_ptr(), bq.data_ptr(),
            wv.data_ptr(), bv.data_ptr(), nbr_mask.data_ptr(),
            scale.data_ptr(), g.data_ptr(), lse.data_ptr(),
            delta.data_ptr(), dq.data_ptr(), dkg.data_ptr(), dvg.data_ptr(),
            d_ef.data_ptr(), partial.data_ptr(), dw.data_ptr(), N, K, H, D,
            C, De,
            torch.cuda.current_stream(dev).cuda_stream)
    if rc != 0:
        raise RuntimeError('dense_attention_rpe_bwd: kernel launch failed '
                           f'with CUDA error {rc}')
    dense_attention_rpe_bwd.launches += 1
    w, b = dw[:De], dw[De]
    return (dq.view(N, H, D), dkg, dvg, d_ef,
            w[:, :DH].contiguous(), b[:DH].contiguous(),
            w[:, DH:2 * DH].contiguous(), b[DH:2 * DH].contiguous(),
            w[:, 2 * DH:].contiguous(), b[2 * DH:].contiguous())


dense_attention_rpe_bwd.launches = 0


class _DenseAttentionRPE(torch.autograd.Function):

    @staticmethod
    def forward(ctx, *args):
        out, lse = dense_attention_rpe(*args, with_lse=True)
        ctx.save_for_backward(*args, out, lse)
        return out

    @staticmethod
    def backward(ctx, g):
        *args, out, lse = ctx.saved_tensors
        grads = dense_attention_rpe_bwd(*args, out, lse, g)
        return tuple(d.to(a.dtype) for d, a in zip(grads, args)) \
            + (None, None)


def dense_attention_rpe_trainable(q_node, k_nodes_g, v_nodes_g, ef, wk, bk,
                                  wq, bq, wv, bv, nbr_mask, scale):
    """`dense_attention_rpe` with a gradient: the forward is the K2 path
    with lse, the backward the K3 path (the JAX package's
    `dense_attention_rpe_trainable`). Gradients flow to the first ten
    arguments, each in its own dtype; the attention matrix is never
    stored."""
    return _DenseAttentionRPE.apply(q_node, k_nodes_g, v_nodes_g, ef, wk,
                                    bk, wq, bq, wv, bv, nbr_mask, scale)
