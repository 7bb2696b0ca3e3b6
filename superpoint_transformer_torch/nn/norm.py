"""GraphNorm and unit-sphere position normalization over padded levels.

Counterpart of `superpoint_transformer_tpu/nn/norm.py` (`GraphNorm`,
`unit_sphere_norm`). Statistics ignore padded rows: `mask` zeroes them
by multiplication, and their graph id (-1) or segment index
(== num_segments) sends them to the segment ops' dump row.
"""
import torch
from torch import nn

from ..ops.segment import (segment_sum, segment_count, segment_max,
                           gather_rows_small)

__all__ = ['GraphNorm', 'unit_sphere_norm']


class GraphNorm(nn.Module):
    """PyG GraphNorm: per-graph mean (scaled by the learnable
    `mean_scale`) and variance normalization, then an affine map."""

    def __init__(self, num_features, num_graphs=64, eps=1e-5,
                 device=None):
        super().__init__()
        self.num_features = num_features
        self.num_graphs = num_graphs
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(num_features, device=device))
        self.bias = nn.Parameter(torch.zeros(num_features, device=device))
        self.mean_scale = nn.Parameter(
            torch.ones(num_features, device=device))

    def forward(self, x, batch=None, mask=None):
        if batch is None:
            batch = torch.zeros(x.shape[0], dtype=torch.long,
                                device=x.device)
        g, C = self.num_graphs, x.shape[1]
        in_dtype = x.dtype
        xm = x if mask is None else x * mask[:, None].to(x.dtype)
        # single pass over concat(x, x^2), squared in the input dtype
        # and summed in f32: E[(x - a*mu)^2] = E[x^2] - 2a*mu*E[x] + (a*mu)^2
        s12 = segment_sum(torch.cat([xm, xm * xm], 1), batch, g,
                          acc_dtype=torch.float32)
        n = segment_count(batch, g, mask=mask).clamp(min=1)
        n = n.to(torch.float32)[:, None]
        mean = s12[:, :C] / n
        ex2 = s12[:, C:] / n
        am = self.mean_scale * mean
        # the E[x^2] identity can go slightly negative in f32
        var = (ex2 - 2 * am * mean + am * am).clamp(min=0.0)
        inv = 1.0 / torch.sqrt(var + self.eps)
        sc = gather_rows_small(inv * self.weight, batch, g)
        sh = gather_rows_small(self.bias - am * inv * self.weight,
                               batch, g)
        return (x.to(torch.float32) * sc + sh).to(in_dtype)


def unit_sphere_norm(pos, super_index, num_super, node_size=None,
                     mask=None):
    """Normalize same-segment positions into a sphere of diameter 1.

    Returns (normalized pos [N, 3], per-segment diameter
    [num_super, 1]). Padded rows (mask False, or an out-of-range
    `super_index`) contribute nothing."""
    big = torch.finfo(pos.dtype).max
    if mask is not None:
        # exile padded rows so they never win the min or the max
        m = mask[:, None]
        p_for_min = torch.where(m, pos, torch.full_like(pos, big))
        p_for_max = torch.where(m, pos, torch.full_like(pos, -big))
    else:
        p_for_min = p_for_max = pos
    # one max pass over concat(pos, -pos) gives both max and min; an
    # empty segment comes out as -inf / +inf
    mxmn = segment_max(torch.cat([p_for_max, -p_for_min], 1),
                       super_index, num_super)
    mx, mn = mxmn[:, :3], -mxmn[:, 3:]
    valid_seg = mx[:, 0] > -big * 0.5
    diameter = torch.where(valid_seg, (mx - mn).amax(1),
                           torch.zeros_like(mx[:, 0]))

    w = (torch.ones(pos.shape[0], dtype=pos.dtype, device=pos.device)
         if node_size is None else node_size)
    if mask is not None:
        w = w * mask.to(w.dtype)
    sums = segment_sum(torch.cat([pos * w[:, None], w[:, None]], 1),
                       super_index, num_super)
    center = sums[:, :3] / sums[:, 3].clamp(min=1e-12)[:, None]
    si = super_index.long().clamp(0, num_super - 1)
    out = (pos - center[si]) / (diameter[si][:, None] + 1e-2)
    return out, diameter[:, None]
