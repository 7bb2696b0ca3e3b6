"""The CUDA kernel of `dense_attention_rpe` vs its plain PyTorch version,
on the card. Every test here is marked `cuda` and skips without a CUDA
device. The file imports neither jax nor the JAX package, so it runs on
a machine without them:

    python -m pytest --noconftest tests/test_torch_cuda.py
"""
import numpy as np
import pytest
import torch

from superpoint_transformer_torch.ops.attention_rpe import (
    dense_attention_rpe, dense_attention_rpe_reference)

# the JAX kernel test's own tolerance: both sides compute in f32 from
# the same inputs, in another summation order
RTOL, ATOL = 2e-4, 2e-5


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
