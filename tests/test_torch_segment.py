"""Port segment ops vs superpoint_transformer_tpu/ops/segment.py,
including the padding indices -1 and == num_segments, which JAX drops
and PyTorch's scatter ops would wrap or reject."""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from superpoint_transformer_tpu.ops import segment as jseg
from superpoint_transformer_torch.ops import segment as tseg

G = 5


def _index(rng, n):
    """Segment ids with padding rows: -1 (graph id of a padded node)
    and G (super_index of a padded child), and an empty segment 3."""
    idx = rng.integers(0, G, n)
    idx[idx == 3] = 0
    idx[rng.random(n) < 0.1] = -1
    idx[rng.random(n) < 0.1] = G
    return idx.astype(np.int32)


# n >= 1024 takes the JAX one-hot matmul form, n < 1024 the scatter
@pytest.mark.parametrize('n', [300, 2048])
@pytest.mark.parametrize('dtype', ['float32', 'bfloat16'])
def test_segment_sum_drops_padding_rows(n, dtype):
    rng = np.random.default_rng(0)
    x = rng.standard_normal((n, 6)).astype(np.float32)
    idx = _index(rng, n)
    ref = jseg.segment_sum(jnp.asarray(x, dtype), jnp.asarray(idx), G,
                           acc_dtype=jnp.float32)
    got = tseg.segment_sum(torch.from_numpy(x).to(getattr(torch, dtype)),
                           torch.from_numpy(idx), G,
                           acc_dtype=torch.float32)
    assert got.dtype == torch.float32 and got.shape == (G, 6)
    # same f32 values, summed in another order
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=1e-5,
                               atol=1e-5)
    assert np.all(got.numpy()[3] == 0)


@pytest.mark.parametrize('n', [300, 2048])
def test_segment_count_with_mask(n):
    rng = np.random.default_rng(1)
    idx = _index(rng, n)
    mask = rng.random(n) < 0.8
    ref = jseg.segment_count(jnp.asarray(idx), G, mask=jnp.asarray(mask))
    got = tseg.segment_count(torch.from_numpy(idx), G,
                             mask=torch.from_numpy(mask))
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref))


def test_segment_max_empty_segment_is_minus_inf():
    rng = np.random.default_rng(2)
    n = 400
    x = rng.standard_normal((n, 4)).astype(np.float32)
    idx = _index(rng, n)
    ref = np.asarray(jseg.segment_max(jnp.asarray(x), jnp.asarray(idx), G))
    got = tseg.segment_max(torch.from_numpy(x), torch.from_numpy(idx),
                           G).numpy()
    np.testing.assert_array_equal(got, ref)
    assert np.all(got[3] == -np.inf)


def test_gather_rows_small_padding_gives_zero_row():
    rng = np.random.default_rng(3)
    table = rng.standard_normal((G, 3)).astype(np.float32)
    idx = np.array([0, 4, -1, 2, -1, 1], np.int32)
    ref = np.asarray(jseg.gather_rows_small(jnp.asarray(table),
                                            jnp.asarray(idx), G))
    got = tseg.gather_rows_small(torch.from_numpy(table),
                                 torch.from_numpy(idx), G).numpy()
    np.testing.assert_array_equal(got, ref)
    assert np.all(got[idx == -1] == 0)


def test_gather_rows_value_and_gradient_match_jax_indexing():
    """`gather_rows` (an embedding lookup) vs JAX's `table[idx]` with rows
    gathered many times, as the attention's neighbor gather does: the
    same rows, and each row's gradient the sum of its cotangents."""
    import jax
    rng = np.random.default_rng(4)
    table = rng.standard_normal((50, 6)).astype(np.float32)
    idx = rng.integers(0, 10, (50, 16))              # heavy duplicates
    w = rng.standard_normal((50, 16, 6)).astype(np.float32)
    ref, ref_grad = jax.value_and_grad(
        lambda t: (t[jnp.asarray(idx)] * w).sum())(jnp.asarray(table))
    t = torch.from_numpy(table).requires_grad_()
    got = tseg.gather_rows(t, torch.from_numpy(idx))
    np.testing.assert_array_equal(got.detach().numpy(), table[idx])
    (got * torch.from_numpy(w)).sum().backward()
    np.testing.assert_allclose(t.grad.numpy(), np.asarray(ref_grad),
                               rtol=1e-5, atol=1e-5)
    assert np.all(t.grad.numpy()[10:] == 0)


def _sorted_index(rng, n, g):
    """Non-decreasing segment ids over `g` segments, some empty, with
    padded rows last at the dump id `g`, as a level sorted by parent."""
    idx = np.sort(rng.integers(0, g, n))
    idx[idx % 7 == 3] = np.maximum(idx[idx % 7 == 3] - 1, 0)
    idx[n - n // 10:] = g
    return idx.astype(np.int32)


# the deterministic paths of the port: one-hot contraction (<= 128
# segments, >= 1024 rows), sorted segmented reduction (given sorted ids,
# or after a stable sort), each against the JAX segment_sum
@pytest.mark.parametrize('path', ['onehot', 'sorted', 'unsorted'])
@pytest.mark.parametrize('dtype', ['float32', 'bfloat16'])
def test_segment_sum_paths_match_jax(path, dtype):
    rng = np.random.default_rng(5)
    n, g = (4096, 100) if path == 'onehot' else (3000, 300)
    idx = _sorted_index(rng, n, g)
    if path == 'unsorted':
        idx = idx[rng.permutation(n)]
    x = rng.standard_normal((n, 3, 2)).astype(np.float32)
    ref = jseg.segment_sum(jnp.asarray(x, dtype), jnp.asarray(idx), g,
                           indices_are_sorted=path != 'unsorted',
                           acc_dtype=jnp.float32)
    got = tseg.segment_sum(torch.from_numpy(x).to(getattr(torch, dtype)),
                           torch.from_numpy(idx), g,
                           indices_are_sorted=path == 'sorted',
                           acc_dtype=torch.float32)
    assert got.dtype == torch.float32 and got.shape == (g, 3, 2)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=1e-5,
                               atol=1e-5)
    empty = np.setdiff1d(np.arange(g), idx)
    assert empty.size and np.all(got.numpy()[empty] == 0)


@pytest.mark.parametrize('path', ['onehot', 'sorted', 'unsorted'])
def test_segment_sum_gradient_matches_jax(path):
    """The gradient of each path is the cotangent of the row's segment
    (zero for dropped rows), as JAX's."""
    import jax
    rng = np.random.default_rng(6)
    n, g = (2048, 64) if path == 'onehot' else (1500, 200)
    idx = _sorted_index(rng, n, g)
    idx[:5] = -1 if path == 'onehot' else idx[:5]
    if path == 'unsorted':
        idx = idx[rng.permutation(n)]
    x = rng.standard_normal((n, 4)).astype(np.float32)
    w = rng.standard_normal((g, 4)).astype(np.float32)
    ref = jax.grad(lambda a: (jseg.segment_sum(
        a, jnp.asarray(idx), g) * w).sum())(jnp.asarray(x))
    t = torch.from_numpy(x).requires_grad_()
    (tseg.segment_sum(t, torch.from_numpy(idx), g,
                      indices_are_sorted=path == 'sorted')
     * torch.from_numpy(w)).sum().backward()
    np.testing.assert_array_equal(t.grad.numpy(), np.asarray(ref))


def test_sorted_segment_sum_takes_a_segment_of_many_rows():
    """A segment of most rows (the backward of a gather whose padded
    slots all point at one row) is cut into pieces and still sums to the
    JAX value, with its gradient."""
    import jax
    rng = np.random.default_rng(8)
    n, g = 5000, 40
    idx = np.sort(rng.integers(0, g, n)).astype(np.int32)
    idx[100:4000] = 3
    idx = np.sort(idx)
    x = rng.standard_normal((n, 3)).astype(np.float32)
    w = rng.standard_normal((g, 3)).astype(np.float32)
    ref, ref_grad = jax.value_and_grad(lambda a: (jseg.segment_sum(
        a, jnp.asarray(idx), g, indices_are_sorted=True) * w).sum())(
        jnp.asarray(x))
    t = torch.from_numpy(x).requires_grad_()
    got = tseg.segment_sum(t, torch.from_numpy(idx), g,
                           indices_are_sorted=True)
    np.testing.assert_allclose(
        got.detach().numpy(), np.asarray(jseg.segment_sum(
            jnp.asarray(x), jnp.asarray(idx), g)), rtol=1e-5, atol=1e-4)
    (got * torch.from_numpy(w)).sum().backward()
    np.testing.assert_allclose(float((got * torch.from_numpy(w)).sum()),
                               float(ref), rtol=1e-5)
    np.testing.assert_array_equal(t.grad.numpy(), np.asarray(ref_grad))
