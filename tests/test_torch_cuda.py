"""The CUDA kernels of the port vs their plain PyTorch versions, on the
card: K1 (`dense_attention`) and its autograd function, K2
(`dense_attention_rpe`), K3 (`dense_attention_rpe_bwd`) and GraphNorm's
serving kernels (`graph_norm`). Every test
here is marked `cuda` and skips without a CUDA device. The file imports neither jax nor the JAX package, so it runs on
a machine without them:

    python -m pytest --noconftest tests/test_torch_cuda.py
"""
import numpy as np
import pytest
import torch

from superpoint_transformer_torch.ops.attention import (
    dense_attention, dense_attention_reference, dense_attention_trainable)
from superpoint_transformer_torch.ops.attention_rpe import (
    dense_attention_rpe, dense_attention_rpe_bwd,
    dense_attention_rpe_bwd_reference, dense_attention_rpe_reference,
    dense_attention_rpe_trainable)

# the JAX kernel tests' own tolerances: both sides compute in f32 from
# the same inputs, in another summation order
RTOL, ATOL = 2e-4, 2e-5              # K2
K1_TOL = dict(rtol=3e-5, atol=3e-5)
K3_TOL = dict(rtol=2e-3, atol=2e-4)
# gradients written in bf16 by both sides from the same f32 math: one
# rounding step (2^-8 relative) may separate them
BF16_TOL = dict(rtol=1.6e-2, atol=1e-3)
# every random input is drawn from a fixed seed; the K3 tests run over a
# few, each its own test case
SEEDS = (0, 1, 2)
# the f32 K3 test adds the seeds whose weight gradients left K3's
# tolerance when the kernel summed them in f32 (a sweep over 20 seeds
# at the flagship shape)
K3_F32_SEEDS = SEEDS + (3, 11, 17)


def _randn(dev, seed, *shape):
    """Standard normal values from a CPU generator seeded with `seed`,
    moved to `dev` (the same values on every card)."""
    gen = torch.Generator().manual_seed(seed)
    return torch.randn(*shape, generator=gen).to(dev)


def _assert_grad_close(name, got, ref, rtol, atol):
    """torch.testing.assert_close, after a check whose message names the
    gradient, its worst element (by error over tolerance), the absolute
    error there and the tolerance atol + rtol*|ref| there."""
    err = (got.float() - ref.float()).abs()
    tol = atol + rtol * ref.float().abs()
    if err.numel() and not bool((err <= tol).all()):
        ratio = torch.where(torch.isnan(err), torch.inf, err / tol)
        i = int(ratio.argmax())
        idx = tuple(int(j) for j in np.unravel_index(i, tuple(err.shape)))
        raise AssertionError(
            f'{name}: worst element {idx}: |got - ref| = '
            f'{err.flatten()[i].item():.4e} > atol + rtol*|ref| = '
            f'{tol.flatten()[i].item():.4e} (got '
            f'{got.flatten()[i].item():.6e}, ref {ref.flatten()[i].item():.6e}'
            f'; rtol {rtol}, atol {atol})')
    torch.testing.assert_close(got, ref, rtol=rtol, atol=atol, msg=name)


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip('needs an NVIDIA GPU: the CUDA kernel has no CPU mode')
    return torch.device('cuda', torch.cuda.current_device())


def _inputs(dev, dtype, N, K, H, D, C, De, masked_rows, seed=0, fill=0.7):
    """K2's arguments; a slot is valid with probability `fill` (slot 0
    always), and the last `masked_rows` rows have none."""
    rng = np.random.default_rng(seed)

    def mk(*s, scale=1.0):
        return torch.from_numpy(
            rng.standard_normal(s).astype(np.float32) * scale).to(dev, dtype)

    args = [mk(N, H, D), mk(N, K, H * D), mk(N, K, C), mk(N, K, De),
            mk(De, H * D, scale=0.3), mk(H * D, scale=0.1),
            mk(De, H * D, scale=0.3), mk(H * D, scale=0.1),
            mk(De, C, scale=0.3), mk(C, scale=0.1)]
    mask = rng.random((N, K)) < fill
    mask[:, 0] = True
    mask[N - masked_rows:] = False
    scale = (rng.random(N) * 0.5 + 0.2).astype(np.float32)
    return args + [torch.from_numpy(mask).to(dev),
                   torch.from_numpy(scale).to(dev)]


@pytest.mark.cuda
@pytest.mark.parametrize('dtype', [torch.float32, torch.bfloat16])
@pytest.mark.parametrize('shape', [
    dict(N=1000, K=37, H=4, D=4, C=32, De=8, masked_rows=7),
    dict(N=10_240, K=48, H=16, D=4, C=64, De=32, masked_rows=100),
    dict(N=1024, K=160, H=16, D=4, C=64, De=32, masked_rows=50),
    dict(N=2048, K=50, H=16, D=4, C=64, De=32, masked_rows=50),
    # nano-2's widths: H*D = C = 32, De = 16 (one k-step of the RPE
    # projection, 4 column tiles a lane)
    dict(N=8192, K=48, H=8, D=4, C=32, De=16, masked_rows=100),
    # SPT-3's level 3 on a tile: fewer nodes than one block's node tile,
    # off the warp tile; and the aerial graphs (graph_k_max 30, gap 30),
    # every one of 32 slots valid
    dict(N=37, K=32, H=16, D=4, C=64, De=32, masked_rows=3),
    dict(N=3001, K=32, H=16, D=4, C=64, De=32, masked_rows=0, fill=1.0),
    # the Delaunay graph's level 1 on a 250k-point room: its degree is
    # not capped (max 150 for a mean of 17.7), so K rounds up to 160 with
    # about one slot in nine valid
    dict(N=5124, K=160, H=16, D=4, C=64, De=32, masked_rows=0, fill=0.11)],
    ids=['ragged', 'flagship', 'wide_k', 'k50', 'nano', 'small_n',
         'full_slots', 'delaunay'])
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


def _k1_inputs(dev, dtype, N, K, H, D, CH, q_per_edge, masked_rows, seed=0,
               fill=0.7):
    rng = np.random.default_rng(seed)

    def mk(*s):
        return torch.from_numpy(
            rng.standard_normal(s).astype(np.float32)).to(dev, dtype)

    q = mk(N, K, H, D) if q_per_edge else mk(N, H, D)
    mask = rng.random((N, K)) < fill
    mask[:, 0] = True
    mask[N - masked_rows:] = False
    scale = (rng.random(N) * 0.5 + 0.2).astype(np.float32)
    return [q, mk(N, K, H, D), mk(N, K, H, CH),
            torch.from_numpy(mask).to(dev), torch.from_numpy(scale).to(dev)]


K1_SHAPES = [dict(N=1000, K=37, H=4, D=4, CH=8, masked_rows=7),
             dict(N=5120, K=48, H=16, D=4, CH=4, masked_rows=100),
             dict(N=1024, K=160, H=16, D=4, CH=4, masked_rows=50),
             dict(N=2048, K=50, H=16, D=4, CH=4, masked_rows=50),
             # nano-2's training attention: 8 heads of 4 channels
             dict(N=4096, K=48, H=8, D=4, CH=4, masked_rows=100),
             # SPT-3's level 3 (fewer nodes than a node tile) and the
             # aerial graphs with every slot valid
             dict(N=37, K=32, H=16, D=4, CH=4, masked_rows=3),
             dict(N=3001, K=32, H=16, D=4, CH=4, masked_rows=0, fill=1.0)]


@pytest.mark.cuda
@pytest.mark.parametrize('dtype', [torch.float32, torch.bfloat16])
@pytest.mark.parametrize('q_per_edge', [False, True],
                         ids=['q_node', 'q_edge'])
@pytest.mark.parametrize('shape', K1_SHAPES,
                         ids=['ragged', 'flagship', 'wide_k', 'k50', 'nano',
                              'small_n', 'full_slots'])
def test_k1_kernel_matches_plain(cuda_device, dtype, q_per_edge, shape):
    args = _k1_inputs(cuda_device, dtype, q_per_edge=q_per_edge, **shape)
    before = dense_attention.launches
    out = dense_attention(*args)
    ref = dense_attention_reference(*args)
    torch.cuda.synchronize()
    assert dense_attention.launches == before + 1
    torch.testing.assert_close(out, ref, **K1_TOL)
    assert torch.all(out[~args[3].any(1)] == 0)


@pytest.mark.cuda
@pytest.mark.parametrize('dtype', [torch.float32, torch.bfloat16])
@pytest.mark.parametrize('q_per_edge', [False, True],
                         ids=['q_node', 'q_edge'])
def test_k1_backward_matches_autograd_of_plain(cuda_device, dtype,
                                               q_per_edge):
    """The autograd function (kernel forward, closed-form backward) vs
    autograd through the plain version on the same values in f32 (the
    closed form, like the JAX backward, differentiates the attention
    without the forward's rounding of q*scale), rounded to `dtype`."""
    args = _k1_inputs(cuda_device, dtype, q_per_edge=q_per_edge,
                      **K1_SHAPES[1])
    w = _randn(cuda_device, 0, args[1].shape[0], 16, 4)
    grads = []
    for fn, cast in ((dense_attention_trainable, dtype),
                     (dense_attention_reference, torch.float32)):
        q, k, v = (a.to(cast, copy=True).requires_grad_() for a in args[:3])
        scale = args[4].clone().requires_grad_()
        (fn(q, k, v, args[3], scale) * w).sum().backward()
        grads.append([t.grad for t in (q, k, v, scale)])
    for name, a, b in zip(('dq', 'dk', 'dv', 'dscale'), *grads):
        tol = BF16_TOL if a.dtype == torch.bfloat16 else K1_TOL
        torch.testing.assert_close(a, b.to(a.dtype), **tol, msg=name)


K3_GRADS = ('dq', 'dkg', 'dvg', 'd_ef', 'dwk', 'dbk', 'dwq', 'dbq', 'dwv',
            'dbv')


K3_FLAGSHIP = dict(N=5120, K=48, H=16, D=4, C=64, De=32)


@pytest.mark.cuda
@pytest.mark.parametrize('seed', K3_F32_SEEDS)
@pytest.mark.parametrize('shape', [
    dict(N=1000, K=37, H=4, D=4, C=32, De=8, masked_rows=7),
    dict(K3_FLAGSHIP, masked_rows=100)],
    ids=['ragged', 'flagship'])
def test_k3_kernel_matches_autograd_of_plain(cuda_device, shape, seed):
    """K3's ten gradients vs autograd through K2's plain version on the
    same values in f64, so that the check measures the kernel's f32
    rounding alone (autograd of the f32 plain version carries rounding
    of its own, up to 0.97 of the tolerance in the weight gradients on
    the card); the weight gradients are the same in two runs (no
    atomics)."""
    args = _inputs(cuda_device, torch.float32, seed=seed, **shape)
    H, C = shape['H'], shape['C']
    g = _randn(cuda_device, seed, shape['N'], H, C // H)
    out, lse = dense_attention_rpe(*args, with_lse=True)
    before = dense_attention_rpe_bwd.launches
    grads = dense_attention_rpe_bwd(*args, out, lse, g)
    again = dense_attention_rpe_bwd(*args, out, lse, g)
    assert dense_attention_rpe_bwd.launches == before + 2
    leaves = [a.double().requires_grad_() for a in args[:10]]
    (dense_attention_rpe_reference(*leaves, *args[10:])
     * g.double()).sum().backward()
    for name, a, t in zip(K3_GRADS, grads, leaves):
        _assert_grad_close(name, a, t.grad.float(), **K3_TOL)
    for name, a, b in zip(K3_GRADS[4:], grads[4:], again[4:]):
        assert torch.equal(a, b), name


@pytest.mark.cuda
@pytest.mark.parametrize('seed', SEEDS)
@pytest.mark.parametrize('shape', [
    dict(N=2048, K=48, H=16, D=4, C=64, De=32, masked_rows=64),
    dict(N=700, K=37, H=2, D=4, C=8, De=8, masked_rows=9)],
    ids=['flagship', 'off_tiles'])
def test_k3_kernel_matches_plain_bf16(cuda_device, shape, seed):
    """The bf16 K3 vs its plain version. `off_tiles`: De and 2*H*D + C
    are not multiples of 16 and K is not a multiple of 16, so the
    tensor-core products run on zero-padded tiles; the last rows are
    fully masked."""
    args = _inputs(cuda_device, torch.bfloat16, seed=seed, **shape)
    H, C = shape['H'], shape['C']
    _hold_k3_bf16(args, _randn(cuda_device, seed, shape['N'], H, C // H))


def _hold_k3_bf16(args, g, forward=dense_attention_rpe):
    """The bf16 K3's ten gradients against its plain version: per-edge
    and per-node ones at BF16_TOL, weight and bias gradients at K3's;
    out and lse from `forward`."""
    out, lse = forward(*args, with_lse=True)
    before = dense_attention_rpe_bwd.launches
    grads = dense_attention_rpe_bwd(*args, out, lse, g)
    assert dense_attention_rpe_bwd.launches == before + 1
    ref = dense_attention_rpe_bwd_reference(*args, out, lse, g)
    for i, (name, a, b) in enumerate(zip(K3_GRADS, grads, ref)):
        assert a.dtype == b.dtype, name
        _assert_grad_close(name, a, b, **(BF16_TOL if i < 4 else K3_TOL))


@pytest.mark.cuda
@pytest.mark.parametrize('K', [1, 15, 16, 17, 33, 64])
def test_k3_bf16_tile_boundaries(cuda_device, K):
    """K on both sides of the kernel's 16-slot tiles, at the flagship
    widths; the last rows are fully masked."""
    args = _inputs(cuda_device, torch.bfloat16, N=1003, K=K, H=16, D=4,
                   C=64, De=32, masked_rows=5, seed=K)
    _hold_k3_bf16(args, _randn(cuda_device, K, 1003, 16, 4))


@pytest.mark.cuda
def test_k3_bf16_nodes_off_the_block_warps(cuda_device):
    """N not a multiple of the block's warps, and more nodes than the
    persistent grid's warps: warps of one block end on different rounds."""
    N = 2 * 8 * 132 + 3
    args = _inputs(cuda_device, torch.bfloat16, N=N, K=40, H=16, D=4, C=64,
                   De=32, masked_rows=11, seed=4)
    _hold_k3_bf16(args, _randn(cuda_device, 4, N, 16, 4))


@pytest.mark.cuda
def test_k3_bf16_reads_column_blocks_of_a_gathered_table(cuda_device):
    """kg and vg as the column blocks of one gathered [N, K, H*D + C]
    table (slot strides above their widths) give the same bits as
    contiguous copies."""
    args = _inputs(cuda_device, torch.bfloat16, N=777, K=37, H=16, D=4,
                   C=64, De=32, masked_rows=3, seed=5)
    g = _randn(cuda_device, 5, 777, 16, 4)
    out, lse = dense_attention_rpe(*args, with_lse=True)
    kv = torch.cat([args[1], args[2]], 2)
    view = list(args)
    view[1], view[2] = kv[..., :64], kv[..., 64:]
    assert view[1].stride(1) == view[2].stride(1) == 128
    for name, a, b in zip(K3_GRADS,
                          dense_attention_rpe_bwd(*view, out, lse, g),
                          dense_attention_rpe_bwd(*args, out, lse, g)):
        assert torch.equal(a, b), name


@pytest.mark.cuda
def test_k3_bf16_takes_rows_off_16_bytes(cuda_device):
    """Rows that are not whole 16-byte chunks (H*D = C = De = 4 in bf16)
    are staged by plain loads; the gradients still hold. K2 does not
    take such rows, so out and lse come from its plain version."""
    args = _inputs(cuda_device, torch.bfloat16, N=300, K=21, H=2, D=2, C=4,
                   De=4, masked_rows=2, seed=6)
    _hold_k3_bf16(args, _randn(cuda_device, 6, 300, 2, 2),
                  forward=dense_attention_rpe_reference)


@pytest.mark.cuda
def test_k3_bf16_rejects_what_it_cannot_take(cuda_device):
    """The bf16 kernel runs its projections in k-steps of 16 up to
    De = 64: a wider De raises, and nothing falls back."""
    args = _inputs(cuda_device, torch.bfloat16, N=64, K=8, H=2, D=4, C=8,
                   De=80, masked_rows=0)
    out = torch.zeros(64, 2, 4, device=cuda_device)
    lse = torch.zeros(2, 64, device=cuda_device)
    before = dense_attention_rpe_bwd.launches
    with pytest.raises(ValueError, match='De = 64'):
        dense_attention_rpe_bwd(*args, out, lse, out)
    assert dense_attention_rpe_bwd.launches == before


@pytest.mark.cuda
@pytest.mark.parametrize('seed', SEEDS)
def test_k3_bf16_weight_gradients_are_reproducible(cuda_device, seed):
    """The bf16 weight and bias gradients are bitwise the same in two
    runs at the flagship training shape (block partials added in block
    order, no atomics)."""
    args = _inputs(cuda_device, torch.bfloat16, seed=seed,
                   masked_rows=100, **K3_FLAGSHIP)
    g = _randn(cuda_device, seed, K3_FLAGSHIP['N'], 16, 4)
    out, lse = dense_attention_rpe(*args, with_lse=True)
    grads = dense_attention_rpe_bwd(*args, out, lse, g)
    again = dense_attention_rpe_bwd(*args, out, lse, g)
    for name, a, b in zip(K3_GRADS[4:], grads[4:], again[4:]):
        assert a.dtype == torch.float32 and torch.equal(a, b), name


@pytest.mark.cuda
def test_rpe_trainable_launches_k2_and_k3(cuda_device):
    args = _inputs(cuda_device, torch.float32, N=512, K=16, H=4, D=4, C=32,
                   De=8, masked_rows=3)
    leaves = [a.clone().requires_grad_() for a in args[:10]]
    k2, k3 = dense_attention_rpe.launches, dense_attention_rpe_bwd.launches
    dense_attention_rpe_trainable(*leaves, *args[10:]).sum().backward()
    assert dense_attention_rpe.launches == k2 + 1
    assert dense_attention_rpe_bwd.launches == k3 + 1
    ref = [a.clone().requires_grad_() for a in args[:10]]
    dense_attention_rpe_reference(*ref, *args[10:]).sum().backward()
    for name, a, b in zip(K3_GRADS, leaves, ref):
        torch.testing.assert_close(a.grad, b.grad, **K3_TOL, msg=name)


@pytest.mark.cuda
def test_k1_and_k3_reject_what_they_cannot_take(cuda_device):
    args = _k1_inputs(cuda_device, torch.float32, N=64, K=8, H=4, D=3, CH=4,
                      q_per_edge=False, masked_rows=0)
    with pytest.raises(ValueError, match='power of two'):
        dense_attention(*args)
    args = _inputs(cuda_device, torch.float32, N=64, K=8, H=4, D=4, C=12,
                   De=4, masked_rows=0)
    g = torch.zeros(64, 4, 3, device=cuda_device)
    out, lse = dense_attention_rpe(*args, with_lse=True)
    with pytest.raises(ValueError, match='power of two'):
        dense_attention_rpe_bwd(*args, out, lse, g)


@pytest.mark.cuda
def test_k1_and_k2_reject_rows_their_copies_cannot_take(cuda_device):
    """The kernels copy 16-byte chunks and keep one head per lane: rows
    that are not a multiple of 16 bytes and more than 32 heads raise."""
    args = _inputs(cuda_device, torch.bfloat16, N=64, K=8, H=4, D=4, C=16,
                   De=4, masked_rows=0)
    with pytest.raises(ValueError, match='16-byte'):
        dense_attention_rpe(*args)
    args = _k1_inputs(cuda_device, torch.bfloat16, N=64, K=8, H=2, D=2,
                      CH=2, q_per_edge=True, masked_rows=0)
    with pytest.raises(ValueError, match='16-byte'):
        dense_attention(*args)
    args = _k1_inputs(cuda_device, torch.float32, N=64, K=8, H=64, D=1,
                      CH=1, q_per_edge=False, masked_rows=0)
    with pytest.raises(ValueError, match='H <= 32'):
        dense_attention(*args)


@pytest.mark.cuda
def test_kernels_launch_after_a_smaller_shape(cuda_device):
    """A kernel's shared-memory limit only grows: the same kernel at a
    large, a small and again the large shape runs and agrees each time."""
    for shape in (K1_SHAPES[1], K1_SHAPES[0], K1_SHAPES[1]):
        args = _k1_inputs(cuda_device, torch.float32, q_per_edge=True,
                          **shape)
        torch.testing.assert_close(dense_attention(*args),
                                   dense_attention_reference(*args),
                                   **K1_TOL)
    for shape in (dict(N=2048, K=48, H=16, D=4, C=64, De=32, masked_rows=0),
                  dict(N=1000, K=37, H=4, D=4, C=32, De=8, masked_rows=0),
                  dict(N=2048, K=48, H=16, D=4, C=64, De=32, masked_rows=0)):
        args = _inputs(cuda_device, torch.float32, **shape)
        torch.testing.assert_close(dense_attention_rpe(*args),
                                   dense_attention_rpe_reference(*args),
                                   rtol=RTOL, atol=ATOL)


@pytest.mark.cuda
def test_flagship_forward_and_step_repeat_bit_for_bit(cuda_device):
    """The flagship model on the card, run twice on the same batch: the
    same logits, and a training step's loss and every gradient the same
    (no float atomics on the forward or the step)."""
    from superpoint_transformer_torch.data.padded import from_numpy
    from superpoint_transformer_torch.experiment import (
        FLAGSHIP_CFG, build_model, build_task)
    from superpoint_transformer_torch.models.semantic import (
        SemanticSegmentationModel)
    from superpoint_transformer_torch.nn.mlp import init_weights
    from superpoint_transformer_torch.utils.synthetic import (
        random_padded_nag)
    host = random_padded_nag(seed=0, num_graphs=2, n_points=20_000,
                             n_l1=1_200, n_l2=300)
    model = SemanticSegmentationModel(build_model(
        FLAGSHIP_CFG, num_graphs=2, device=cuda_device), 13)
    init_weights(model, torch.Generator().manual_seed(0))
    model.eval()
    batch = from_numpy(host, cuda_device, model.net.compute_dtype)
    with torch.inference_mode():
        a, b = model(batch), model(batch)
    assert all(torch.equal(x, y) for x, y in zip(a, b))

    task = build_task(FLAGSHIP_CFG, num_graphs=2, device=cuda_device)
    init_weights(task.model, torch.Generator().manual_seed(0))
    tb = from_numpy(host, cuda_device, model.net.compute_dtype, train=True)
    assert tb[1].nbr_in_idx is not None
    runs = []
    for _ in range(2):
        task.model.train()
        task.optimizer.zero_grad(set_to_none=True)
        loss, _ = task.loss(tb)
        loss.backward()
        runs.append((loss.detach(), [p.grad.clone() for p in
                                     task.model.parameters()]))
    assert torch.equal(runs[0][0], runs[1][0])
    assert all(torch.equal(x, y) for x, y in zip(runs[0][1], runs[1][1]))


@pytest.mark.cuda
@pytest.mark.parametrize('case', ['onehot', 'sorted', 'unsorted',
                                  'gather'])
def test_segment_sums_on_the_card_match_the_cpu_and_repeat(cuda_device,
                                                           case):
    """The float segment sums and the gathers' backward on the card: the
    CPU's values within f32 rounding, bit-equal in two runs, with long
    runs of padded rows on both sides (never read by the sorted
    reduction)."""
    from superpoint_transformer_torch.ops.segment import (gather_rows,
                                                          segment_sum)
    rng = np.random.default_rng(7)
    n, g = (300_000, 64) if case == 'onehot' else (200_000, 3_000)
    idx = np.sort(rng.integers(0, g, n))
    idx[:1000], idx[n - 150_000:] = -1, g
    if case in ('unsorted', 'gather'):
        idx = rng.permutation(np.clip(idx, 0, g - 1) if case == 'gather'
                              else idx)
    x = rng.standard_normal((n, 8)).astype(np.float32)
    runs = []
    for dev in (torch.device('cpu'), cuda_device, cuda_device):
        i = torch.from_numpy(idx).to(dev)
        if case == 'gather':
            t = torch.from_numpy(x[:g]).to(dev).requires_grad_()
            gather_rows(t, i).backward(torch.from_numpy(x).to(dev))
            runs.append(t.grad.cpu())
        else:
            runs.append(segment_sum(
                torch.from_numpy(x).to(dev), i, g,
                indices_are_sorted=case == 'sorted').cpu())
    torch.testing.assert_close(runs[1], runs[0], rtol=1e-5, atol=1e-4)
    assert torch.equal(runs[1], runs[2])


# GraphNorm's kernels (`ops/graph_norm.py`): the shapes of the serving
# forwards' norms. (rows, channels, graphs, mask, ids): level 0 of a DALES
# request (8 tiles of ~173k points, the point MLP's widest norm), the
# S3DIS level-1 edge MLP (~41.6k nodes x K = 48 slots, ~60% valid), a
# level-3 norm of fewer rows than one block's tile, the most graphs the
# kernels take at C = 128 (shared memory above 48 KB), graph ids in no
# order, and rows that are not whole 16-byte chunks
GN_SHAPES = {
    'dales_level0': (1_400_000, 128, 8, 'node', 'sorted'),
    's3dis_edges': (41_600 * 48, 32, 8, 'edge', 'sorted'),
    'level3': (100, 64, 8, 'node', 'sorted'),
    'many_graphs': (300_000, 128, 128, 'node', 'sorted'),
    'unsorted': (200_000, 64, 8, 'node', 'unsorted'),
    'narrow_rows': (5_000, 12, 8, 'node', 'sorted'),
}


def _gn_case(dev, name, dtype=torch.bfloat16, seed=0):
    """A GraphNorm of random affine parameters and its inputs at
    `GN_SHAPES[name]`: rows sorted by graph with a padded tail (id -1,
    masked out), each graph's channels off 0 by its own mean; an edge
    mask marks a random ~60% of each node's 48 slots."""
    from superpoint_transformer_torch.nn.norm import GraphNorm
    N, C, g, kind, order = GN_SHAPES[name]
    gen = torch.Generator(device=dev).manual_seed(seed)
    if kind == 'edge':
        nodes = N // 48
        node_ids = torch.sort(torch.randint(0, g, (nodes,), generator=gen,
                                            device=dev)).values
        node_ids[-nodes // 20:] = -1
        ids = node_ids.repeat_interleave(48)
        mask = (torch.rand(N, generator=gen, device=dev) < 0.6) & (ids >= 0)
    else:
        ids = torch.sort(torch.randint(0, g, (N,), generator=gen,
                                       device=dev)).values
        ids[N - max(1, N // 20):] = -1
        mask = ids >= 0
    if order == 'unsorted':
        p = torch.randperm(N, generator=gen, device=dev)
        ids, mask = ids[p], mask[p]
    means = torch.randn(g + 1, C, generator=gen, device=dev) * 2
    x = (torch.randn(N, C, generator=gen, device=dev)
         + means[ids.clamp(min=0)]).to(dtype)
    gn = GraphNorm(C, num_graphs=g, device=dev)
    with torch.no_grad():
        gn.weight.uniform_(0.5, 1.5, generator=gen)
        gn.bias.normal_(generator=gen)
        gn.mean_scale.uniform_(0, 1.5, generator=gen)
    return gn, x, ids, mask


# GraphNorm's bf16 output against its PyTorch path on the same values in
# f32, rounded once: one bf16 step (2^-7 relative at most) of the output,
# or of the O(1) terms x * scale and shift that cancel into a small output
# (their f32 sums differ in order; the mean's share of E[x^2], up to ~17x
# the variance in these graphs, amplifies that)
GN_TOL = dict(rtol=2 ** -7, atol=2 ** -7)


@pytest.mark.cuda
@pytest.mark.parametrize('leaky', [False, True], ids=['affine', 'leaky'])
@pytest.mark.parametrize('name', list(GN_SHAPES))
def test_graph_norm_kernels_match_the_plain_path(cuda_device, name, leaky):
    """The kernels against GraphNorm's PyTorch path on the same values in
    f32 (in bf16 that path squares in bf16, which moves the variance of a
    graph of a dozen rows by ~1%), its LeakyReLU in f32, rounded to
    bf16."""
    from superpoint_transformer_torch.ops.graph_norm import graph_norm
    gn, x, ids, mask = _gn_case(cuda_device, name)
    fused = graph_norm.fused
    with torch.no_grad():
        got = gn(x, batch=ids, mask=mask, leaky=leaky)
    with torch.enable_grad():
        want = gn._plain(x.float(), ids, mask).detach()
    if leaky:
        want = torch.nn.functional.leaky_relu(want, 0.01)
    assert graph_norm.fused == fused + 1
    assert got.dtype == x.dtype
    _assert_grad_close(name, got.float(), want.to(x.dtype).float(),
                       **GN_TOL)


@pytest.mark.cuda
def test_graph_norm_kernels_match_the_plain_version_in_f32(cuda_device):
    from superpoint_transformer_torch.ops.graph_norm import (
        graph_norm, graph_norm_reference)
    gn, x, ids, mask = _gn_case(cuda_device, 'unsorted', torch.float32)
    args = (gn.weight, gn.bias, gn.mean_scale, gn.eps, gn.num_graphs)
    with torch.no_grad():
        got = graph_norm(x, ids, mask, *args, leaky=True)
        want = graph_norm_reference(x, ids, mask, *args, leaky=True)
    _assert_grad_close('f32', got, want, rtol=1e-4, atol=2e-4)


@pytest.mark.cuda
@pytest.mark.parametrize('name', ['dales_level0', 'unsorted',
                                  'many_graphs'])
def test_graph_norm_kernels_repeat_bit_for_bit(cuda_device, name):
    gn, x, ids, mask = _gn_case(cuda_device, name, seed=1)
    with torch.no_grad():
        a = gn(x, batch=ids, mask=mask, leaky=True)
        b = gn(x, batch=ids, mask=mask, leaky=True)
    assert torch.equal(a, b)


def _spt3_batch():
    """A 2-graph, 4-level batch at about 1/20 of a DALES tile's measured
    node counts (173k points, 1,488, 399 and 176 nodes), 6 point
    features, up to 54 valid neighbour slots."""
    from superpoint_transformer_torch.utils.synthetic import (
        random_padded_nag)
    return random_padded_nag(seed=0, num_graphs=2, n_points=8650, n_l1=74,
                             n_l2=20, n_l3=9, degree=(4, 54), num_classes=8,
                             point_dim=6)


@pytest.mark.cuda
def test_spt3_forward_with_the_graph_norm_kernels(cuda_device):
    """A whole SPT-3 (DALES) forward on the card, in f32 and in bf16 from
    the same weights: every GraphNorm takes the kernels without gradients
    (30 a forward) and none with them (forced so: PyTorch's path). In f32
    the two forwards' level-1 logits differ by the order of the norms'
    sums, which the random network amplifies to a few 1e-4 of logits of
    up to ~10 (seeds 0-2 of the weights read 2.5e-4 to 6.5e-4). In bf16
    both sit at the format's noise over random weights, ~0.22 mean from
    the f32 logits, so the kernels' forward must be as close to the f32
    one as PyTorch's path is (seeds 0-2: mean error ratio 0.89-0.98,
    argmax agreement 0.019 below PyTorch's path's to 0.044 above)."""
    from superpoint_transformer_torch.data.padded import from_numpy
    from superpoint_transformer_torch.experiment import (DALES_CFG,
                                                         build_model)
    from superpoint_transformer_torch.models.semantic import (
        SemanticSegmentationModel)
    from superpoint_transformer_torch.nn.mlp import init_weights
    from superpoint_transformer_torch.ops.graph_norm import graph_norm
    host = _spt3_batch()
    m = torch.from_numpy(host.levels[1].node_mask).to(cuda_device)
    logits = {}
    for compute_dtype in (None, 'bfloat16'):
        model = SemanticSegmentationModel(build_model(
            DALES_CFG, num_graphs=2, compute_dtype=compute_dtype,
            device=cuda_device), 8, device=cuda_device)
        init_weights(model, torch.Generator().manual_seed(0))
        model.eval()
        batch = from_numpy(host, cuda_device, model.net.compute_dtype)
        for grad in (False, True):
            calls, fused = graph_norm.calls, graph_norm.fused
            with torch.set_grad_enabled(grad):
                z = model(batch)[0].detach().float()[m]
            assert graph_norm.calls - calls == 30
            assert graph_norm.fused - fused == (0 if grad else 30)
            assert torch.isfinite(z).all()
            logits[compute_dtype, grad] = z
    f32 = logits[None, True]
    torch.testing.assert_close(logits[None, False], f32, rtol=1e-3,
                               atol=1e-3)
    err = {grad: (logits['bfloat16', grad] - f32).abs().mean()
           for grad in (False, True)}
    agree = {grad: (logits['bfloat16', grad].argmax(1)
                    == f32.argmax(1)).float().mean()
             for grad in (False, True)}
    assert err[False] <= 1.25 * err[True], err
    assert agree[False] >= agree[True] - 0.02, agree


@pytest.mark.cuda
def test_flagship_step_keeps_the_plain_graph_norm(cuda_device):
    """The training step runs every GraphNorm on the PyTorch path (20
    a forward), and a serving forward runs all of them on the kernels."""
    from superpoint_transformer_torch.data.padded import from_numpy
    from superpoint_transformer_torch.experiment import (FLAGSHIP_CFG,
                                                         build_task)
    from superpoint_transformer_torch.nn.mlp import init_weights
    from superpoint_transformer_torch.ops.graph_norm import graph_norm
    from superpoint_transformer_torch.utils.synthetic import (
        random_padded_nag)
    host = random_padded_nag(seed=0, num_graphs=2, n_points=20_000,
                             n_l1=1_200, n_l2=300)
    task = build_task(FLAGSHIP_CFG, num_graphs=2, device=cuda_device)
    init_weights(task.model, torch.Generator().manual_seed(0))
    cd = task.model.net.compute_dtype
    calls, fused = graph_norm.calls, graph_norm.fused
    task.train_step(from_numpy(host, cuda_device, cd, train=True))
    assert (graph_norm.calls - calls, graph_norm.fused - fused) == (20, 0)
    task.model.eval()
    with torch.inference_mode():
        task.model(from_numpy(host, cuda_device, cd))
    assert (graph_norm.calls - calls, graph_norm.fused - fused) == (40, 20)
