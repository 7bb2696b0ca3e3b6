"""GraphNorm's forward without gradients, fused (`nn/norm.py:GraphNorm`).

Per graph, the f32 sums of x and x^2 over the rows in range and masked
in, and their count; then the scale and shift of `GraphNorm`'s formula;
then y = x * scale[graph] + shift[graph] in f32 (LeakyReLU with slope
0.01 on request) rounded once to x's dtype, 0 on rows whose graph id is
out of range. On a CUDA tensor `graph_norm` launches the three
hand-written kernels of `csrc/graph_norm.cu` (statistics, finalize,
apply; built with nvcc at first use, bound through ctypes) or raises; on
a CPU tensor it runs `graph_norm_reference`, the plain PyTorch version
of the same arithmetic. No TPU kernel stands behind it: the JAX
GraphNorm is XLA ops.

Counters: `graph_norm.calls` counts `GraphNorm.forward`'s forwards,
`graph_norm.fused` those that took this function (both added by the
forward), `graph_norm.launches` the calls that launched the kernels.
`scale_shift` is GraphNorm's formula from the sums, which the PyTorch
path and the plain version share.
"""
import ctypes
import functools

import torch
import torch.nn.functional as F

from ..utils.flops import opaque
from .cuda_build import library
from .segment import _ONEHOT_MAX_SEGMENTS

__all__ = ['graph_norm', 'graph_norm_reference', 'scale_shift',
           'MAX_GRAPHS']

# the most graphs the kernels take: the segment ops' one-hot cap, so
# that at C = 128 the statistics' accumulators fit a block's shared memory
MAX_GRAPHS = _ONEHOT_MAX_SEGMENTS
# the MLPs' LeakyReLU (`nn/mlp.py:leaky_relu`), also `kSlope` in the kernels
LEAKY_SLOPE = 0.01


@functools.lru_cache(maxsize=None)
def _launcher():
    fn = library('graph_norm').graph_norm_launch
    p, i = ctypes.c_void_p, ctypes.c_int
    fn.argtypes = [i, p, p, p, p, p, p, ctypes.c_float, i, i, i, i, i, i,
                   p, p, p]
    fn.restype = i
    return fn


@functools.lru_cache(maxsize=None)
def _sms(index):
    return torch.cuda.get_device_properties(index).multi_processor_count


def _stat_blocks(N, g, esz, sms):
    """Row ranges of the statistics pass: up to 4 a multiprocessor, at
    least 256 rows each, and partial sums ([blocks, g, 2C + 1] f32) of at
    most a sixteenth of x's bytes."""
    return max(1, min(4 * sms, -(-N // 256), N * esz // (128 * g)))


def _flops(N, C, g):
    """The contractions the unfused forward counts (`utils/flops.py`):
    the one-hot sums of [x, x^2] and of the count (over at least 1024
    rows, `ops/segment.py:segment_sum`) and the two one-hot gathers of
    the scale and the shift."""
    sums = 2 * N * g * (2 * C + 1) if N >= 1024 else 0
    return sums + 2 * 2 * N * g * C


def scale_shift(s1, s2, n, weight, bias, mean_scale, eps):
    """GraphNorm's per-graph scale and shift [g, C] from the f32 sums of
    x (`s1`) and x^2 (`s2`) [g, C] over `n` rows [g, 1] (clamped at 1):
    the formula of the kernels' finalize and of `GraphNorm`'s PyTorch
    path alike."""
    n = n.clamp(min=1)
    mean = s1 / n
    ex2 = s2 / n
    am = mean_scale * mean
    # the E[x^2] identity can go slightly negative in f32
    var = (ex2 - 2 * am * mean + am * am).clamp(min=0.0)
    inv = 1.0 / torch.sqrt(var + eps)
    return inv * weight, bias - am * inv * weight


def graph_norm_reference(x, batch, mask, weight, bias, mean_scale, eps,
                         num_graphs, leaky=False):
    """Plain PyTorch version of the kernels: the same f32 arithmetic,
    the sums in another order (`index_add_` into a dump row for the rows
    that add nothing)."""
    f32 = torch.float32
    g, (N, C) = num_graphs, x.shape
    b = (torch.zeros(N, dtype=torch.long, device=x.device)
         if batch is None else batch.long())
    ok = (b >= 0) & (b < g)
    into = ok if mask is None else ok & mask
    xf = x.to(f32)
    rows = torch.cat([xf, xf * xf, torch.ones(N, 1, dtype=f32,
                                              device=x.device)], 1)
    s = torch.zeros(g + 1, 2 * C + 1, dtype=f32, device=x.device).index_add_(
        0, torch.where(into, b, g), rows)[:g]
    sc, sh = scale_shift(s[:, :C], s[:, C:2 * C], s[:, 2 * C:], weight,
                         bias, mean_scale, eps)
    row = torch.where(ok, b, 0)
    y = xf * sc[row] + sh[row]
    if leaky:
        y = F.leaky_relu(y, negative_slope=LEAKY_SLOPE)
    return torch.where(ok[:, None], y, 0.0).to(x.dtype)


def _check(name, t, dtype, shape, device):
    if t.device != device or t.dtype != dtype \
            or tuple(t.shape) != tuple(shape) or not t.is_contiguous():
        raise ValueError(
            f'graph_norm: {name} must be a contiguous {dtype} tensor of '
            f'shape {tuple(shape)} on {device} (got {t.dtype} '
            f'{tuple(t.shape)} on {t.device})')


def graph_norm(x, batch, mask, weight, bias, mean_scale, eps, num_graphs,
               leaky=False):
    """GraphNorm's forward over the rows of x [N, C].

    :param x: [N, C] f32 or bf16, contiguous
    :param batch: [N] int64 graph ids (-1 or >= num_graphs on padded
        rows), or None for one graph
    :param mask: [N] bool rows that count in the statistics, or None
    :param weight, bias, mean_scale: [C] f32
    :param leaky: apply LeakyReLU (slope 0.01) before the rounding
    :return: [N, C] in x's dtype

    CPU tensors run the plain version; CUDA tensors launch the kernels
    or raise. At most `MAX_GRAPHS` graphs. Not differentiable.
    """
    dev, g = x.device, num_graphs
    if x.dim() != 2 or x.dtype not in (torch.float32, torch.bfloat16):
        raise ValueError('graph_norm: x must be [N, C] float32 or bfloat16')
    N, C = x.shape
    if not 1 <= g <= MAX_GRAPHS:
        raise ValueError(f'graph_norm: {g} graphs (1 to {MAX_GRAPHS})')
    _check('x', x, x.dtype, (N, C), dev)
    if batch is not None:
        _check('batch', batch, torch.int64, (N,), dev)
    if mask is not None:
        _check('mask', mask, torch.bool, (N,), dev)
    for name, t in (('weight', weight), ('bias', bias),
                    ('mean_scale', mean_scale)):
        _check(name, t, torch.float32, (C,), dev)
    with opaque(_flops(N, C, g)):
        if dev.type == 'cpu':
            return graph_norm_reference(x, batch, mask, weight, bias,
                                        mean_scale, eps, g, leaky)
        if dev.type != 'cuda' or dev.index != torch.cuda.current_device():
            raise ValueError(f'graph_norm: tensors on {dev}; the kernels '
                             'run on the current CUDA device')
        y = torch.empty_like(x)
        sms = _sms(dev.index)
        blocks = _stat_blocks(N, g, x.element_size(), sms)
        work = torch.empty(blocks * g * (2 * C + 1) + g * 2 * C,
                           dtype=torch.float32, device=dev)
        rc = _launcher()(
            int(x.dtype == torch.bfloat16), x.data_ptr(),
            None if batch is None else batch.data_ptr(),
            None if mask is None else mask.data_ptr(), weight.data_ptr(),
            bias.data_ptr(), mean_scale.data_ptr(), float(eps), int(leaky),
            N, C, g, blocks, sms, work.data_ptr(), y.data_ptr(),
            torch.cuda.current_stream(dev).cuda_stream)
    if rc != 0:
        raise RuntimeError(
            f'graph_norm: kernel launch failed with CUDA error {rc}')
    graph_norm.launches += 1
    return y


# GraphNorm forwards, those that took this function, and the calls of it
# that launched the kernels, since the process started
graph_norm.calls = 0
graph_norm.fused = 0
graph_norm.launches = 0
