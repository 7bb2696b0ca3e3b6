"""Why the bf16 K3 kernel splits its gradient rows into two bf16 parts.

K3's bf16 variant (`csrc/dense_attention_rpe_bwd.cu`) computes the
edge-feature gradient d_ef = G . [wk | wq | wv]^T and the weight and bias
gradients [ef | 1]^T . G on the tensor cores, whose operands are bf16.
The edge features and the weights are bf16 inputs, exact as operands; the
gradient rows G = [dk_full | dq_full | dv] are f32. This emulates the
tensor cores in plain PyTorch (bf16 operands, exact products, f32 sums)
at the flagship widths and shows that G = hi + lo, two bf16 parts and two
products, stays within K3's tolerance of the f32 products, where one
bf16 rounding of G does not.
"""
import numpy as np
import pytest
import torch

from superpoint_transformer_torch.ops.attention_rpe import (
    _rpe_bwd_rows, dense_attention_rpe)

K3_TOL = dict(rtol=2e-3, atol=2e-4)   # K3's tolerance on the card
FLAGSHIP = dict(N=256, K=48, H=16, D=4, C=64, De=32)


def _inputs(seed, N, K, H, D, C, De):
    rng = np.random.default_rng(seed)

    def mk(*s, scale=1.0):
        return torch.from_numpy(
            rng.standard_normal(s).astype(np.float32) * scale).to(
                torch.bfloat16)

    args = [mk(N, H, D), mk(N, K, H * D), mk(N, K, C), mk(N, K, De),
            mk(De, H * D, scale=0.3), mk(H * D, scale=0.1),
            mk(De, H * D, scale=0.3), mk(H * D, scale=0.1),
            mk(De, C, scale=0.3), mk(C, scale=0.1)]
    mask = rng.random((N, K)) < 0.7
    mask[:, 0] = True
    mask[-8:] = False
    scale = (rng.random(N) * 0.5 + 0.2).astype(np.float32)
    g = torch.from_numpy(
        rng.standard_normal((N, H, C // H)).astype(np.float32))
    return args + [torch.from_numpy(mask), torch.from_numpy(scale)], g


def _worst_ratio(got, ref):
    """The largest |got - ref| / (atol + rtol |ref|) under K3_TOL."""
    tol = K3_TOL['atol'] + K3_TOL['rtol'] * ref.abs()
    return ((got - ref).abs() / tol).max().item()


def _bf16(t):
    return t.to(torch.bfloat16).to(torch.float32)


@pytest.mark.parametrize('seed', [0, 1, 2])
def test_hi_lo_split_keeps_k3_products_within_tolerance(seed):
    args, g = _inputs(seed, **FLAGSHIP)
    out, lse = dense_attention_rpe(*args, with_lse=True)
    e, dk_full, dq_full, dv = _rpe_bwd_rows(*args, out, lse, g)
    De = e.shape[2]
    G = torch.cat([dk_full, dq_full, dv], 2).flatten(0, 1)
    e1 = torch.cat([e.reshape(-1, De), torch.ones(G.shape[0], 1)], 1)
    w = torch.cat([args[4], args[6], args[8]], 1).float()   # exact bf16
    hi = _bf16(G)
    lo = _bf16(G - hi)
    # the plain version's f32 products
    ref_def, ref_dw = G @ w.t(), e1.t() @ G
    split = (_worst_ratio(hi @ w.t() + lo @ w.t(), ref_def),
             _worst_ratio(e1.t() @ hi + e1.t() @ lo, ref_dw))
    hi_only = (_worst_ratio(hi @ w.t(), ref_def),
               _worst_ratio(e1.t() @ hi, ref_dw))
    assert max(split) <= 1.0, split
    # one rounding of G (2^-9 relative) breaks the tolerance by far
    assert min(hi_only) > 10.0, hi_only
