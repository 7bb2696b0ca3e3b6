"""GraphNorm's fused forward (`ops/graph_norm.py`) on the CPU: its plain
version against `nn/norm.py:GraphNorm`'s PyTorch path, and the rule by
which `GraphNorm.forward` takes the kernels. The kernels themselves are
held to both on the card (`tests/test_torch_cuda.py`)."""
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from superpoint_transformer_torch.nn import norm as norm_mod
from superpoint_transformer_torch.nn.norm import GraphNorm
from superpoint_transformer_torch.ops.graph_norm import graph_norm

# The same f32 formula on sums of ~2,000 rows taken in another order
# (index_add_ against a one-hot product): they differ by up to ~1e-6 of
# E[x^2], which the E[x^2] - mean^2 identity amplifies by E[x^2] / var
# (up to ~40 in these graphs, whose means sit 3 sigma off 0). In bf16
# both sides round the f32 output once, so adjacent values may differ by
# one bf16 step (2^-7 relative at most).
TOL = {torch.float32: dict(rtol=1e-4, atol=2e-4),
       torch.bfloat16: dict(rtol=2 ** -7, atol=2e-4)}


def _case(seed, N, C, g, dtype, masked, order):
    """Rows of g graphs sorted by graph (or shuffled), each graph's
    channels shifted by its own mean; a tail of padded rows, half with id
    -1 and half with ids >= g (some of them masked in); with `masked`, a
    fifth of the valid rows masked out."""
    rng = np.random.default_rng(seed)
    pad = N // 10
    ids = np.concatenate([np.sort(rng.integers(0, g, N - pad)),
                          -np.ones(pad // 2, np.int64),
                          g + rng.integers(0, 3, pad - pad // 2)])
    x = rng.standard_normal((N, C)) * rng.uniform(0.5, 2, C) \
        + rng.standard_normal((g + 4, C))[np.clip(ids, 0, g + 3)] * 3
    mask = rng.random(N) > (0.2 if masked else -1)
    if order == 'unsorted':
        p = rng.permutation(N)
        ids, x, mask = ids[p], x[p], mask[p]
    gn = GraphNorm(C, num_graphs=g)
    with torch.no_grad():
        gn.weight.copy_(torch.from_numpy(rng.uniform(0.5, 1.5, C)))
        gn.bias.copy_(torch.from_numpy(rng.standard_normal(C)))
        gn.mean_scale.copy_(torch.from_numpy(rng.uniform(0, 1.5, C)))
    return (torch.from_numpy(x).to(dtype), torch.from_numpy(ids),
            torch.from_numpy(mask) if masked else None, gn)


@pytest.mark.parametrize('leaky', [False, True], ids=['affine', 'leaky'])
@pytest.mark.parametrize('g', [1, 8, 128])
@pytest.mark.parametrize('order', ['sorted', 'unsorted'])
@pytest.mark.parametrize('masked', [False, True], ids=['all', 'masked'])
@pytest.mark.parametrize('dtype', [torch.float32, torch.bfloat16],
                         ids=['f32', 'bf16'])
def test_plain_version_matches_graph_norm(dtype, masked, order, g, leaky):
    """The plain version against GraphNorm's PyTorch path on the same
    values in f32 (in bf16 that path squares in bf16, which moves the
    variance of a graph of a few rows by up to ~1%), then rounded."""
    x, ids, mask, gn = _case(g, 2048, 24, g, dtype, masked, order)
    with torch.no_grad():
        want = gn(x.float(), batch=ids, mask=mask)
        if leaky:
            want = F.leaky_relu(want, 0.01)
        want = want.to(dtype)
        got = graph_norm(x, ids, mask, gn.weight, gn.bias, gn.mean_scale,
                         gn.eps, g, leaky=leaky)
    assert got.dtype == dtype
    padded = (ids < 0) | (ids >= g)
    assert torch.equal(got[padded], torch.zeros_like(got[padded]))
    if mask is not None:
        # masked-out rows of a valid graph take the affine map
        off = ~mask & ~padded
        assert off.any() and bool((got[off] != 0).any())
    torch.testing.assert_close(got.float(), want.float(), **TOL[dtype])


def test_plain_version_counts_rows_of_no_graph_as_graph_zero():
    x, _, _, gn = _case(3, 1500, 8, 1, torch.float32, False, 'sorted')
    with torch.no_grad():
        want = gn(x)
        got = graph_norm(x, None, None, gn.weight, gn.bias, gn.mean_scale,
                         gn.eps, 1)
    torch.testing.assert_close(got, want, **TOL[torch.float32])


@pytest.fixture
def fake_card(monkeypatch):
    """Every tensor claims to be on a card, so the CPU shows which path
    `GraphNorm.forward` takes (`graph_norm` runs its plain version on CPU
    tensors); a shard group of one rank."""
    monkeypatch.setattr(torch.Tensor, 'is_cuda', property(lambda t: True))
    monkeypatch.setattr(norm_mod, 'all_reduce_sum', lambda t, group: t)


@pytest.mark.parametrize('case', ['serving', 'grad', 'sharded',
                                  'many_graphs', 'cpu'])
def test_forward_takes_the_kernels_only_without_gradients_on_a_card(
        request, case):
    g = 129 if case == 'many_graphs' else 8
    x, ids, mask, gn = _case(5, 1500, 16, g, torch.bfloat16, True, 'sorted')
    if case != 'cpu':
        request.getfixturevalue('fake_card')
    if case == 'sharded':
        gn.shard_group = object()
    calls, fused = graph_norm.calls, graph_norm.fused
    with torch.set_grad_enabled(case == 'grad'):
        got = gn(x, batch=ids, mask=mask, leaky=True)
        plain = F.leaky_relu(gn._plain(x, ids, mask), 0.01)
    assert graph_norm.calls == calls + 1
    if case == 'serving':
        assert graph_norm.fused == fused + 1
        # the plain path squares in bf16: one rounding apart at most
        torch.testing.assert_close(got.float(), plain.float(),
                                   rtol=2 ** -7, atol=2 ** -7)
    else:
        assert graph_norm.fused == fused
        assert torch.equal(got, plain)


@pytest.mark.parametrize('bad', ['dtype', 'graphs', 'batch', 'mask',
                                 'weight'])
def test_graph_norm_rejects_what_the_kernels_cannot_take(bad):
    x, ids, mask, gn = _case(6, 64, 8, 4, torch.float32, True, 'sorted')
    w, g = gn.weight.detach(), 4
    if bad == 'dtype':
        x = x.half()
    elif bad == 'graphs':
        g = 129
    elif bad == 'batch':
        ids = ids.int()
    elif bad == 'mask':
        mask = mask.float()
    else:
        w = w[:4]
    with pytest.raises(ValueError, match='graph_norm'):
        graph_norm(x, ids, mask, w, gn.bias, gn.mean_scale, gn.eps, g)
