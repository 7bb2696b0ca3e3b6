"""The losses, metrics and position encodings that the JAX package exports
and nothing of it calls, against their port on the CPU: the focal,
weighted (L1, L2, BCE) and Lovasz losses (values within 1e-6, relative
above 1; gradients through autograd within 1e-5 of `jax.grad`; tied
errors included), the `WeightedL1Error` / `WeightedL2Error` accumulators
(float64 on both sides: 1e-12), and the five injections with the flax
weights carried
across by `load_jax_params` (within 1e-6; the Fourier features of angles
up to ~100 rad within 1e-5, one f32 ulp of such an angle being ~8e-6).
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from superpoint_transformer_tpu import loss as jloss
from superpoint_transformer_tpu.metrics import weighted_li as jli
from superpoint_transformer_tpu.nn import position_encoding as jpe
from superpoint_transformer_torch import loss as tloss
from superpoint_transformer_torch import metrics as tmetrics
from superpoint_transformer_torch.nn import position_encoding as tpe
from superpoint_transformer_torch.utils.jax_params import load_jax_params

VALUE_TOL = 1e-6
GRAD_ATOL = 1e-5
METRIC_RTOL = 1e-12
PE_ATOL = 1e-6
FOURIER_ATOL = 1e-5
N, C = 64, 6


def _inputs(seed, tied):
    """logits [N, C], labels [N] (some -1), mask [N], item weights [N].
    `tied` repeats the first 16 rows 3 times over (same logits, same
    label), so that errors tie, and masks a quarter of the rows (their
    errors are zero)."""
    rng = np.random.default_rng(seed)
    logits = rng.normal(0, 2, (N, C)).astype(np.float32)
    y = rng.integers(0, C, N)
    y[rng.random(N) < 0.1] = -1
    mask = np.ones(N, bool)
    if tied:
        logits[16:] = np.tile(logits[:16], (3, 1))
        y[16:] = np.tile(y[:16], 3)
        mask[rng.permutation(N)[:N // 4]] = False
    w = rng.random(N).astype(np.float32)
    return logits, y, mask, w


def _check(jfn, tfn, x, *rest):
    """The value and the gradient with respect to `x` of each side."""
    ref, ref_g = jax.value_and_grad(jfn)(jnp.asarray(x), *rest)
    xt = torch.tensor(x, requires_grad=True)
    got = tfn(xt, *rest)
    got.backward()
    np.testing.assert_allclose(got.item(), float(ref), rtol=VALUE_TOL,
                               atol=VALUE_TOL)
    np.testing.assert_allclose(xt.grad.numpy(), np.asarray(ref_g), rtol=0,
                               atol=GRAD_ATOL)
    assert np.abs(np.asarray(ref_g)).max() > 0


CASES = [(seed, tied) for seed in (0, 1) for tied in (False, True)]


@pytest.mark.parametrize('seed,tied', CASES)
@pytest.mark.parametrize('gamma', [0.0, 2.0])
def test_weighted_focal_loss_matches_jax(seed, tied, gamma):
    logits, y, mask, w = _inputs(seed, tied)
    cw = np.linspace(0.5, 2.0, C).astype(np.float32)

    def run(mod, arr):
        return lambda x: mod.weighted_focal_loss(
            x, arr(y), gamma=gamma, class_weight=cw, item_weight=arr(w),
            mask=arr(mask))
    _check(run(jloss, jnp.asarray), run(tloss, torch.as_tensor), logits)


@pytest.mark.parametrize('seed,tied', CASES)
def test_binary_focal_loss_matches_jax(seed, tied):
    logits, y, mask, _ = _inputs(seed, tied)
    p = 1 / (1 + np.exp(-logits[:, 0]))
    target = (y > 2).astype(np.int64)

    def run(mod, arr):
        return lambda x: mod.binary_focal_loss(
            x, arr(target), gamma=2.0, weight=0.3, mask=arr(mask))
    _check(run(jloss, jnp.asarray), run(tloss, torch.as_tensor), p)


@pytest.mark.parametrize('name', ['weighted_l1_loss', 'weighted_l2_loss',
                                  'weighted_bce_with_logits_loss'])
@pytest.mark.parametrize('weighted', [False, True])
def test_weighted_losses_match_jax(name, weighted):
    logits, y, mask, w = _inputs(2, False)
    target = (np.random.default_rng(3).random((N, C)) < 0.4).astype(
        np.float32)
    extra = {}
    if name.startswith('weighted_bce'):
        extra = {'pos_weight': 2.0}

    def run(mod, arr):
        return lambda x: getattr(mod, name)(
            x, arr(target), weight=arr(w) if weighted else None,
            mask=arr(mask) if weighted else None, **extra)
    _check(run(jloss, jnp.asarray), run(tloss, torch.as_tensor), logits)


@pytest.mark.parametrize('seed,tied', CASES)
@pytest.mark.parametrize('class_to_sum', ['present', 'all'])
def test_lovasz_softmax_loss_matches_jax(seed, tied, class_to_sum):
    """With tied errors the gradient depends on the order the sort gives
    equal errors: both sides sort stably."""
    logits, y, mask, _ = _inputs(seed, tied)
    cw = np.linspace(0.5, 2.0, C).astype(np.float32)

    def run(mod, arr):
        return lambda x: mod.lovasz_softmax_loss(
            x, arr(y), class_to_sum=class_to_sum, mask=arr(mask),
            class_weight=cw)
    _check(run(jloss, jnp.asarray), run(tloss, torch.as_tensor), logits)


@pytest.mark.parametrize('order', [1, 2])
def test_weighted_error_metrics_match_jax(order):
    rng = np.random.default_rng(order)
    name = f'WeightedL{order}Error'
    ref, got = getattr(jli, name)(), getattr(tmetrics, name)()
    for i in range(3):
        pred = rng.normal(size=(50, 3)).astype(np.float32)
        target = rng.normal(size=(50, 3)).astype(np.float32)
        w = None if i == 0 else rng.random(50)
        ref.update(pred, target, w)
        # the port's update takes tensors too
        got.update(torch.from_numpy(pred), target,
                   None if w is None else torch.from_numpy(w))
    assert got.compute() > 0
    np.testing.assert_allclose(got.compute(), ref.compute(),
                               rtol=METRIC_RTOL)
    got.reset()
    assert got.compute() == 0.0


POS_DIM, X_DIM, NUM_GRAPHS = 3, 8, 2
INJECTIONS = {
    'cat': ({}, {}),
    'additive': ({}, dict(pos_dim=POS_DIM, x_dim=X_DIM)),
    'mlp': (dict(hidden=16, num_graphs=NUM_GRAPHS),
            dict(pos_dim=POS_DIM, x_dim=X_DIM, hidden=16,
                 num_graphs=NUM_GRAPHS)),
    'fourier': (dict(num_bands=6, max_freq=32.0),
                dict(num_bands=6, max_freq=32.0)),
    'learnable_fourier': (dict(num_features=12, scale=10.0),
                          dict(pos_dim=POS_DIM, num_features=12,
                               scale=10.0)),
}


@pytest.mark.parametrize('name', list(INJECTIONS))
@pytest.mark.parametrize('with_x', [True, False])
def test_injections_match_jax(name, with_x):
    """Each injection's flax weights (if any) load into the port's module
    by name, and the outputs agree, with and without features."""
    rng = np.random.default_rng(4)
    n = 40
    pos = rng.uniform(-1, 1, (n, POS_DIM)).astype(np.float32)
    x = rng.normal(size=(n, X_DIM)).astype(np.float32) if with_x else None
    batch = np.repeat(np.arange(NUM_GRAPHS), n // NUM_GRAPHS)
    mask = rng.random(n) < 0.9
    jkw, tkw = INJECTIONS[name]
    jmod = jpe.injection_factory(name)(**jkw)
    args = (jnp.asarray(pos), None if x is None else jnp.asarray(x))
    kw = dict(batch=jnp.asarray(batch), mask=jnp.asarray(mask))
    # without features the JAX module makes no parameters: draw them
    # with features
    variables = jmod.init(jax.random.PRNGKey(0), args[0],
                          jnp.zeros((n, X_DIM)), **kw)
    ref = np.asarray(jmod.apply(variables, *args, **kw))
    tmod = tpe.injection_factory(name)(**tkw)
    load_jax_params(tmod, jax.tree_util.tree_map(
        np.array, variables.get('params', {})))
    with torch.no_grad():
        got = tmod(torch.from_numpy(pos),
                   None if x is None else torch.from_numpy(x),
                   batch=torch.from_numpy(batch),
                   mask=torch.from_numpy(mask)).numpy()
    assert got.shape == ref.shape
    atol = FOURIER_ATOL if name == 'fourier' else PE_ATOL
    np.testing.assert_allclose(got, ref, rtol=0, atol=atol)
    if with_x and name in ('additive', 'mlp'):
        assert not np.allclose(got[:, -X_DIM:], x)


def test_learnable_fourier_draws_from_its_generator():
    a = tpe.LearnableFourierInjection(3, generator=torch.Generator()
                                      .manual_seed(0))
    b = tpe.LearnableFourierInjection(3, generator=torch.Generator()
                                      .manual_seed(0))
    assert torch.equal(a.freq, b.freq)
    assert abs(a.freq.std().item() - 10.0) < 4.0
