"""The numerics of the bf16 K3 kernel's tile design, emulated on the CPU.

K3's bf16 variant (`csrc/dense_attention_rpe_bwd.cu`, namespace `tiles`)
walks each node's slots in tiles of 16 (zero rows past K), runs the RPE
projections and the edge-feature gradient d_ef = G . [wk | wq | wv]^T on
the tensor cores (bf16 operands, exact products, f32 sums; G as two bf16
parts hi + lo), takes p with exp2 in log2 units, and sums the weight and
bias gradients from the f32 G on FMAs in a fixed order: each block of a
persistent grid sums, round by round, the 16 staged rows of each of its
warps in warp order and adds the round's sums to its partial sums, and
the block partials are added in block order. This
emulates that arithmetic in plain PyTorch and holds it to autograd of
the plain version in f64 at K3's tolerance, so that the design's
summation order is judged before the card runs it.
"""
import math

import pytest
import torch

from superpoint_transformer_torch.ops.attention_rpe import (
    dense_attention_rpe, dense_attention_rpe_reference)
from test_torch_k3_precision import K3_TOL, _inputs, _worst_ratio

TILE = 16
WARPS = 8          # warps a block at the flagship widths
SMS = 132          # one block an SM on an H100
LOG2E = 1.4426950408889634
GRADS = ('dq', 'dkg', 'dvg', 'd_ef', 'dwk', 'dbk', 'dwq', 'dbq', 'dwv',
         'dbv')


def _bf16(t):
    return t.to(torch.bfloat16).to(torch.float32)


def _pad(t, Kp):
    """Zero rows past K up to Kp along the slot axis."""
    pad = torch.zeros((t.shape[0], Kp - t.shape[1], *t.shape[2:]),
                      dtype=t.dtype)
    return torch.cat([t, pad], 1)


def _block_order_sums(e, G, N, tiles):
    """[ef | 1]^T G over every slot in the kernel's order: block b of the
    persistent grid owns warps b*WARPS .., warp gw the nodes gw, gw + TW,
    ...; a round is one tile of each live warp, its 16 rows added in
    order into f32 round sums, which are added to the block's partial
    sums; the block partials are added in block order."""
    blocks = min(-(-N // WARPS), SMS)
    tw = blocks * WARPS
    e1 = torch.cat([e, torch.ones(*e.shape[:2], 1)], 2)
    total = torch.zeros(e1.shape[2], G.shape[2])
    for b in range(blocks):
        part = torch.zeros_like(total)
        gw0 = b * WARPS
        for rr in range(-(-(N - gw0) // tw) * tiles):
            node, t = divmod(rr, tiles)
            acc = torch.zeros_like(total)
            for w in range(WARPS):
                n = gw0 + w + node * tw
                if n >= N:
                    break
                for r in range(t * TILE, (t + 1) * TILE):
                    acc = torch.addcmul(acc, e1[n, r][:, None],
                                        G[n, r][None])
            part = part + acc
        total = total + part
    return total


def emulate_k3_tiles(q, kg, vg, ef, wk, bk, wq, bq, wv, bv, mask, scale, out,
                     lse, g):
    """The ten gradients as the bf16 kernel computes them, in f32 (before
    the per-edge outputs are rounded to bf16)."""
    N, K, DH = kg.shape
    H, D, C = q.shape[1], q.shape[2], vg.shape[2]
    tiles = max(1, math.ceil(K / TILE))
    Kp = tiles * TILE
    kgp, vgp, efp = (_pad(t.float(), Kp) for t in (kg, vg, ef))
    maskp = _pad(mask, Kp)
    w = torch.cat([wk, wq, wv], 1).float()            # exact bf16 operands
    b = torch.cat([bk, bq, bv]).float()
    proj = efp @ w + b                                 # f32 sums over De
    kf = kgp + proj[..., :DH]
    qf = q.float().reshape(N, 1, DH) + proj[..., DH:2 * DH]
    vf = vgp + proj[..., 2 * DH:]
    logit2 = (qf * kf).reshape(N, Kp, H, D).sum(-1) \
        * (scale * LOG2E)[:, None, None]
    p = torch.where(maskp[..., None],
                    torch.exp2(logit2 - lse.t()[:, None, :] * LOG2E),
                    torch.zeros(()))
    gh = g.reshape(N, H, C // H)
    delta = (gh * out).sum(-1)                         # the caller's
    gv = (gh[:, None] * vf.reshape(N, Kp, H, C // H)).sum(-1)
    e = p * (gv - delta[:, None]) * scale[:, None, None]
    dv = (p[..., None] * gh[:, None]).reshape(N, Kp, C)
    e_d = e.repeat_interleave(D, 2)
    dk, dqf = e_d * qf, e_d * kf
    G = torch.cat([dk, dqf, dv], 2)
    hi = _bf16(G)
    lo = _bf16(G - hi)
    d_ef = hi @ w.t() + lo @ w.t()
    # the weight-gradient FMAs read G in f32 (as hi + lo, its 2^-18
    # relative error in every term put the sums over N*K slots up to 1.4x
    # K3's tolerance from f64)
    sums = _block_order_sums(efp, G, N, tiles)
    dwt, dbt = sums[:-1], sums[-1]
    return (dqf.sum(1).reshape(N, H, D), dk[:, :K], dv[:, :K], d_ef[:, :K],
            dwt[:, :DH], dbt[:DH], dwt[:, DH:2 * DH], dbt[DH:2 * DH],
            dwt[:, 2 * DH:], dbt[2 * DH:])


@pytest.mark.parametrize('K', [16, 17, 48])
@pytest.mark.parametrize('seed', [0, 1, 2])
def test_tile_emulation_matches_f64_autograd(seed, K):
    args, g = _inputs(seed, N=256, K=K, H=16, D=4, C=64, De=32)
    out, lse = dense_attention_rpe(*args, with_lse=True)
    got = emulate_k3_tiles(*args, out, lse, g)
    leaves = [a.double().requires_grad_() for a in args[:10]]
    (dense_attention_rpe_reference(*leaves, *args[10:])
     * g.double()).sum().backward()
    ratios = {name: _worst_ratio(a.double(), t.grad)
              for name, a, t in zip(GRADS, got, leaves)}
    assert max(ratios.values()) <= 1.0, ratios
