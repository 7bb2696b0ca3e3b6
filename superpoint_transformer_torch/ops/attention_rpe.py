"""Streaming dense-neighbor attention with in-kernel RPE.

Port of the TPU kernel `dense_attention_rpe_pallas`
(`superpoint_transformer_tpu/ops/pallas_attention.py`), which serves
every attention block of the flagship model at inference. On a CUDA
tensor `dense_attention_rpe` launches the hand-written Hopper kernel in
`csrc/dense_attention_rpe.cu` (built with nvcc for sm_90a at first use,
bound through ctypes) or raises; on a CPU tensor it runs
`dense_attention_rpe_reference`, the plain PyTorch version of the same
function. The public layouts are the JAX ones: gathered keys
[N, K, H*D], gathered values [N, K, C], output [N, H, C/H] f32, lse
[H, N] f32.
"""
import ctypes
import functools
import os
import shutil
import subprocess
from pathlib import Path

import torch

__all__ = ['dense_attention_rpe', 'dense_attention_rpe_reference',
           'build']

_PKG = Path(__file__).resolve().parents[1]
_SRC = _PKG / 'csrc' / 'dense_attention_rpe.cu'
_BUILD_DIR = _PKG / '_build'
_LIB = _BUILD_DIR / 'libdense_attention_rpe.so'
NVCC_FLAGS = ('-gencode', 'arch=compute_90a,code=sm_90a', '-std=c++17',
              '-O3', '-shared', '-Xcompiler', '-fPIC', '-Xptxas', '-v')


def _nvcc():
    home = os.environ.get('CUDA_HOME') or os.environ.get('CUDA_PATH') \
        or '/usr/local/cuda'
    path = Path(home) / 'bin' / 'nvcc'
    if path.exists():
        return str(path)
    found = shutil.which('nvcc')
    if found is None:
        raise RuntimeError(
            'nvcc not found: set CUDA_HOME to a CUDA toolkit to build '
            f'{_SRC.name}')
    return found


def build(force=False):
    """Compile the kernel into `_build/` when `force` is set or the
    library is missing or older than its source. Returns the compiler's
    report (registers, shared memory and spills per kernel), or '' when
    the library was already up to date."""
    if not force and _LIB.exists() \
            and _LIB.stat().st_mtime >= _SRC.stat().st_mtime:
        return ''
    _BUILD_DIR.mkdir(exist_ok=True)
    tmp = _LIB.with_name(f'{_LIB.name}.{os.getpid()}.tmp')
    res = subprocess.run([_nvcc(), *NVCC_FLAGS, '-o', str(tmp), str(_SRC)],
                         capture_output=True, text=True)
    if res.returncode != 0:
        raise RuntimeError(f'nvcc failed on {_SRC}:\n{res.stderr}')
    os.replace(tmp, _LIB)
    return res.stderr


@functools.lru_cache(maxsize=None)
def _launcher():
    build()
    fn = ctypes.CDLL(str(_LIB)).dense_attention_rpe_launch
    p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    fn.argtypes = ([i, p, p, ll, p, ll] + [p] * 11 + [i] * 6 + [p])
    fn.restype = i
    return fn


def dense_attention_rpe_reference(q_node, k_nodes_g, v_nodes_g, ef, wk,
                                  bk, wq, bq, wv, bv, nbr_mask, scale,
                                  with_lse=False):
    """Plain PyTorch version of the kernel (the JAX package's
    `_rpe_xla_reference`, plus the kernel's lse). Inputs are rounded to
    the dtype of `k_nodes_g` and the math runs in f32, as in the
    kernel."""
    N, K, DH = k_nodes_g.shape
    H, D = q_node.shape[1], q_node.shape[2]
    C = v_nodes_g.shape[2]
    dt, f32 = k_nodes_g.dtype, torch.float32

    def c(t):
        return t.to(dt).to(f32)

    e = c(ef)
    k = c(k_nodes_g) + e @ c(wk) + c(bk)                  # [N, K, DH]
    q = c(q_node).reshape(N, 1, DH) + e @ c(wq) + c(bq)   # [N, K, DH]
    v = c(v_nodes_g) + e @ c(wv) + c(bv)                  # [N, K, C]
    logit = (q * k).reshape(N, K, H, D).sum(-1) \
        * scale.to(f32)[:, None, None]                    # [N, K, H]
    m3 = nbr_mask[:, :, None]
    logit = torch.where(m3, logit, torch.full_like(logit, -1e30))
    mx = logit.amax(1, keepdim=True)
    p = torch.exp(logit - mx) * m3.to(f32)
    denom = p.sum(1).clamp(min=1e-30)                     # [N, H]
    out = torch.einsum('nkh,nkhc->nhc', p,
                       v.reshape(N, K, H, C // H)) / denom[:, :, None]
    if with_lse:
        return out, (mx[:, 0] + torch.log(denom)).t().contiguous()
    return out


def _check(name, t, dtype, shape, device):
    if t.device != device:
        raise ValueError(f'{name} is on {t.device}, expected {device}')
    if t.dtype != dtype:
        raise ValueError(f'{name} has dtype {t.dtype}, expected {dtype}')
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f'{name} has shape {tuple(t.shape)}, '
                         f'expected {tuple(shape)}')


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
    kg, vg = k_nodes_g, v_nodes_g
    dev = kg.device
    if dev.type not in ('cpu', 'cuda'):
        raise ValueError(f'dense_attention_rpe: tensors on {dev}; the '
                         'kernel runs on a CUDA device')
    # the same layout rules on both devices, so that the CPU tests catch
    # what the kernel would refuse
    if kg.dim() != 3 or vg.dim() != 3 or q_node.dim() != 3 \
            or ef.dim() != 3:
        raise ValueError('dense_attention_rpe: q_node, k_nodes_g, '
                         'v_nodes_g and ef must be 3-D')
    N, K, DH = kg.shape
    H, D = q_node.shape[1], q_node.shape[2]
    C, De = vg.shape[2], ef.shape[2]
    dt = kg.dtype
    if dt not in (torch.float32, torch.bfloat16):
        raise ValueError(f'dense_attention_rpe: dtype {dt} unsupported '
                         '(float32 or bfloat16)')
    if DH != H * D or C % H != 0:
        raise ValueError(f'dense_attention_rpe: H*D={H * D} vs {DH}, '
                         f'C={C} vs H={H}')
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
            raise ValueError(f'dense_attention_rpe: {name} must be '
                             'contiguous')
    ldk, ldv = kg.stride(1), vg.stride(1)
    if kg.stride() != (K * ldk, ldk, 1) or vg.stride() != (K * ldv, ldv, 1):
        raise ValueError(
            'dense_attention_rpe: k_nodes_g / v_nodes_g need a contiguous '
            f'last axis and [N, K] row layout (strides {kg.stride()}, '
            f'{vg.stride()})')
    if dev.type == 'cpu':
        return dense_attention_rpe_reference(
            q_node, kg, vg, ef, wk, bk, wq, bq, wv, bv, nbr_mask, scale,
            with_lse=with_lse)

    if dev.index != torch.cuda.current_device():
        raise ValueError(f'dense_attention_rpe: tensors on {dev}, not on '
                         'the current CUDA device')
    if D > 32 or D & (D - 1) or DH > 128 or C > 128:
        raise ValueError(
            f'dense_attention_rpe: kernel needs D a power of two <= 32, '
            f'H*D <= 128 and C <= 128 (got D={D}, H*D={DH}, C={C})')
    out = torch.empty((N, C), dtype=torch.float32, device=dev)
    lse = torch.empty((H, N), dtype=torch.float32, device=dev) \
        if with_lse else None
    rc = _launcher()(
        int(dt == torch.bfloat16), q_node.data_ptr(), kg.data_ptr(), ldk,
        vg.data_ptr(), ldv, ef.data_ptr(), wk.data_ptr(), bk.data_ptr(),
        wq.data_ptr(), bq.data_ptr(), wv.data_ptr(), bv.data_ptr(),
        nbr_mask.data_ptr(), scale.data_ptr(), out.data_ptr(),
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
