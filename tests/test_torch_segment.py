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
