"""Model FLOPs of a PyTorch function, for MFU estimates.

Counterpart of `superpoint_transformer_tpu/utils/flops.py`, with its
convention: only contractions count, 2*M*N*K per matrix product and
2*out*Cin*k per convolution; element-wise work does not. JAX walks the
jaxpr, where its Pallas kernels are opaque; here a dispatch mode counts
the ATen products (`mm`, `addmm`, `bmm`, `baddbmm`, convolutions) of one
call, forward and backward, and the attention kernels K1, K2 and K3 are
not opaque: each call adds its contractions at its shapes
(`ops/cost.py:contraction_flops`), whether it launches the kernel or runs
its plain version, and counts nothing of what runs inside it. The plain
versions write some contractions as element-wise products and sums
(<q, k> over D); `count_contraction` adds those, with twice as much in
the backward, so that a model counts the same with its kernels or with
`plain_attention`.

Outside `matmul_flops` every hook here is a no-op.
"""
import contextlib
import math

import torch
from torch.utils._python_dispatch import TorchDispatchMode

__all__ = ['matmul_flops', 'count_contraction', 'opaque']

aten = torch.ops.aten


class _State:
    counter = None      # the active _Counter
    paused = 0          # depth of `opaque` blocks


_STATE = _State()


_PRODUCTS = {aten.mm.default, aten.addmm.default, aten.bmm.default,
             aten.baddbmm.default, aten.convolution.default,
             aten.convolution_backward.default}


def _product_flops(func, args, out):
    """The FLOPs of the product `func` (one of _PRODUCTS)."""
    if func in (aten.mm.default, aten.addmm.default):
        a, b = args[-2], args[-1]
        return 2 * a.shape[0] * a.shape[1] * b.shape[1]
    if func in (aten.bmm.default, aten.baddbmm.default):
        a, b = args[-2], args[-1]
        return 2 * a.shape[0] * a.shape[1] * a.shape[2] * b.shape[2]
    if func is aten.convolution.default:
        # the weight is [Cout, Cin / groups, *kernel]
        w = args[1]
        return 2 * out.numel() * w.shape[1] * math.prod(w.shape[2:])
    # convolution_backward: grad_input and grad_weight, twice the
    # forward's products
    grad_out, w = args[0], args[2]
    return 4 * grad_out.numel() * w.shape[1] * math.prod(w.shape[2:])


class _Counter(TorchDispatchMode):

    def __init__(self):
        super().__init__()
        self.total = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        if func not in _PRODUCTS:
            # under inference_mode a composite op (linear, matmul, einsum)
            # reaches the mode whole: count the products it decomposes
            # into, as outside it
            with self:
                out = func.decompose(*args, **kwargs)
            if out is NotImplemented:
                out = func(*args, **kwargs)
            return out
        out = func(*args, **kwargs)
        if not _STATE.paused:
            self.total += _product_flops(func, args, out)
        return out


def _record(flops):
    if _STATE.counter is not None and not _STATE.paused:
        _STATE.counter.total += int(flops)


@contextlib.contextmanager
def opaque(flops):
    """Count `flops` for the block, and nothing that runs inside it: a
    kernel call, or its plain version, counted by its shapes."""
    _record(flops)
    _STATE.paused += 1
    try:
        yield
    finally:
        _STATE.paused -= 1


class _BackwardFlops(torch.autograd.Function):

    @staticmethod
    def forward(ctx, x, flops):
        ctx.flops = flops
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        _record(ctx.flops)
        return g, None


def count_contraction(t, flops, backward_flops=None):
    """`t`, the result of a contraction written element-wise, counted as
    `flops` (and `backward_flops`, by default 2 * flops, when a gradient
    flows back through it). Returns `t` itself outside `matmul_flops`."""
    if _STATE.counter is None or _STATE.paused:
        return t
    _record(flops)
    if backward_flops is None:
        backward_flops = 2 * flops
    if t.requires_grad and torch.is_grad_enabled() and backward_flops:
        return _BackwardFlops.apply(t, backward_flops)
    return t


def matmul_flops(fn, *args, **kwargs):
    """Total contraction FLOPs of one call of `fn(*args, **kwargs)`: it
    runs once, on the device of its inputs, with a backward where `fn`
    runs one."""
    if _STATE.counter is not None:
        raise RuntimeError('matmul_flops: already counting')
    counter = _Counter()
    _STATE.counter = counter
    try:
        with counter:
            fn(*args, **kwargs)
    finally:
        _STATE.counter = None
    return counter.total
