"""Collectives over an explicit `torch.distributed` process group: what
`jax.lax.psum`, `pmin`, `pmax` and `all_gather` give the JAX package
inside `shard_map`.

Every rank calls each op in the same order with tensors of one shape.
Gradients follow the JAX transposes: the backward of a sum over ranks
sums the cotangents over ranks, and the backward of a row gather keeps
this rank's rows of the summed cotangent. So when every rank
back-propagates the same replicated loss, each rank's gradient counts
the loss once per rank (`parallel/mesh.py` divides the summed gradients
by the world size).

gloo has no reduce-scatter, so `all_gather_rows`' backward is an
all-reduce and a slice.
"""
import torch
import torch.distributed as dist

__all__ = ['all_reduce_sum', 'all_reduce_min', 'all_reduce_max',
           'all_gather_rows', 'all_reduce_mean_']


def _all_reduce(x, op, group):
    out = x.detach().clone()
    dist.all_reduce(out, op=op, group=group)
    return out


class _AllReduceSum(torch.autograd.Function):

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return _all_reduce(x, dist.ReduceOp.SUM, group)

    @staticmethod
    def backward(ctx, grad):
        return _all_reduce(grad.contiguous(), dist.ReduceOp.SUM,
                           ctx.group), None


def all_reduce_sum(x, group):
    """The sum of `x` over the ranks of `group` (`psum`); its backward
    is the sum of the ranks' cotangents."""
    return _AllReduceSum.apply(x, group)


def all_reduce_min(x, group):
    """The elementwise minimum of `x` over the ranks (`pmin`), without a
    gradient."""
    return _all_reduce(x, dist.ReduceOp.MIN, group)


def all_reduce_max(x, group):
    """The elementwise maximum of `x` over the ranks (`pmax`), without a
    gradient."""
    return _all_reduce(x, dist.ReduceOp.MAX, group)


class _AllGatherRows(torch.autograd.Function):

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        ctx.rank = dist.get_rank(group)
        ctx.rows = x.shape[0]
        parts = [torch.empty_like(x) for _ in range(dist.get_world_size(
            group))]
        dist.all_gather(parts, x.detach().contiguous(), group=group)
        return torch.cat(parts)

    @staticmethod
    def backward(ctx, grad):
        full = _all_reduce(grad.contiguous(), dist.ReduceOp.SUM, ctx.group)
        lo = ctx.rank * ctx.rows
        return full[lo:lo + ctx.rows], None


def all_gather_rows(x, group):
    """The ranks' row tables `x` [R, ...], concatenated in rank order
    ([world * R, ...]; `all_gather` with `tiled=True`). Its backward sums
    the full cotangent over the ranks and keeps this rank's rows."""
    return _AllGatherRows.apply(x, group)


@torch.no_grad()
def all_reduce_mean_(tensors, group):
    """Replace each tensor of the list, in place, by its mean over the
    ranks (`pmean`), all in one flat bucket and one collective. The
    tensors share a dtype and every rank passes the same shapes."""
    if not tensors:
        return
    flat = torch.cat([t.reshape(-1) for t in tensors])
    dist.all_reduce(flat, group=group)
    flat /= dist.get_world_size(group)
    offset = 0
    for t in tensors:
        t.copy_(flat[offset:offset + t.numel()].view_as(t))
        offset += t.numel()
