"""The device half of the port's `ops/geometry.py` (`eigh_3x3`,
`neighborhood_pca`, `geometric_features`) against the JAX package's
jitted functions, on the CPU, from the same numpy inputs.

Both sides run the same closed-form arithmetic in f32, each with its own
arccos, cos, sqrt and 3x3 matmul. Eigenvalues of well-separated spectra
(gaps above 5e-2 of the scale) are held to 1e-5 of the matrix's scale,
and their eigenvectors to 1e-4.
Near a repeated eigenvalue the trigonometric method loses half its
digits (arccos is read where its slope is infinite, so a rounding of the
input, 6e-8 relative, splits the pair by up to sqrt(6e-8) = 2.4e-4 of the
scale, on each side): there the eigenvalues are held to 5e-4 of the
scale, and only the eigenvector of the simple eigenvalue, up to sign, is
compared; an isotropic matrix gives the identity basis on both sides.
The features (all of order 1) are held to 1e-4; the normal (the
eigenvector of the smallest eigenvalue) only where the planarity (the
gap of the two smallest eigenvalues' square roots over the largest's)
is above 5e-2, and the verticality (all three eigenvectors) where the
linearity is too."""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from superpoint_transformer_tpu.ops import geometry as jgeo
from superpoint_transformer_torch.ops import geometry as tgeo
from superpoint_transformer_torch.ops.native import radius_knn
from test_torch_trainer import one_torch_thread  # noqa: F401

EIG_ATOL = 1e-5
DEGENERATE_ATOL = 5e-4
VEC_ATOL = 1e-4
FEAT_ATOL = 1e-4
# relative gap above which an eigenvector is compared
GAP = 5e-2


def _eigh_both(A):
    jw, jV = jax.jit(jgeo.eigh_3x3)(jnp.asarray(A))
    tw, tV = tgeo.eigh_3x3(torch.from_numpy(A))
    return tw.numpy(), tV.numpy(), np.asarray(jw), np.asarray(jV)


def _rotations(n, seed):
    q, _ = np.linalg.qr(np.random.default_rng(seed).normal(size=(n, 3, 3)))
    return q


def test_eigh_3x3_random_spectra_match_jax():
    rng = np.random.default_rng(0)
    X = rng.normal(size=(2_000, 3, 3)).astype(np.float32)
    A = X @ X.transpose(0, 2, 1)
    w, V, jw, jV = _eigh_both(A)
    scale = np.abs(A).max((1, 2))[:, None]
    gap = np.diff(jw, axis=1).min(1) / scale[:, 0]
    sep = gap > GAP
    assert sep.mean() > 0.9
    np.testing.assert_allclose(w[sep] / scale[sep], jw[sep] / scale[sep],
                               rtol=0, atol=EIG_ATOL)
    np.testing.assert_allclose(w / scale, jw / scale, rtol=0,
                               atol=DEGENERATE_ATOL)
    # well-separated spectra: the same eigenvectors, sign included
    np.testing.assert_allclose(V[sep], jV[sep], rtol=0, atol=VEC_ATOL)
    # increasing, and an eigenbasis of A
    assert (np.diff(w, axis=1) >= 0).all()
    err = np.abs(A @ V - V * w[:, None, :]).max((1, 2))
    assert (err[sep] / scale[sep, 0] < 1e-4).all()


@pytest.mark.parametrize('spectrum', [(1., 1., 2.), (2., 1., 1.),
                                      (0., 0., 1.), (0., 1., 1.)],
                         ids=['low_pair', 'high_pair', 'rank1', 'rank2'])
def test_eigh_3x3_degenerate_spectra_match_jax(spectrum):
    R = _rotations(200, seed=1)
    D = np.diag(np.asarray(spectrum, np.float64))
    A = np.concatenate([D[None], R @ D @ R.transpose(0, 2, 1)]).astype(
        np.float32)
    w, V, jw, jV = _eigh_both(A)
    np.testing.assert_allclose(w, jw, rtol=0, atol=DEGENERATE_ATOL)
    np.testing.assert_allclose(w, np.broadcast_to(sorted(spectrum), w.shape),
                               rtol=0, atol=DEGENERATE_ATOL)
    # the eigenvector of the simple eigenvalue (the largest, or else the
    # smallest), up to sign
    simple = 2 if spectrum.count(max(spectrum)) == 1 else 0
    dots = np.abs((V[:, :, simple] * jV[:, :, simple]).sum(1))
    np.testing.assert_allclose(dots, 1.0, rtol=0, atol=VEC_ATOL)


def test_eigh_3x3_isotropic_gives_the_identity_basis():
    A = np.stack([np.eye(3) * s for s in (0.0, 1e-3, 1.0, 7.0)]).astype(
        np.float32)
    w, V, jw, jV = _eigh_both(A)
    np.testing.assert_array_equal(w, jw)
    np.testing.assert_array_equal(V, np.broadcast_to(np.eye(3), V.shape))
    np.testing.assert_array_equal(jV, V)


@pytest.fixture(scope='module')
def neighborhoods():
    """A slab of points (planar at coarse scale, so the features span
    their ranges) and its 20-NN table with -1 at invalid slots."""
    rng = np.random.default_rng(2)
    pos = rng.uniform(0, 1, (600, 3)).astype(np.float32)
    pos[:, 2] *= 0.05
    pos[:100, 0] = 0.5 + 0.001 * rng.normal(size=100)   # a thin line
    nbr, _ = radius_knn(pos, r=0.2, k=20)
    return pos, nbr.astype(np.int64)


@pytest.mark.parametrize('k_step, kw', [
    (-1, {}), (-1, dict(add_self=False, orient_normal_z=False,
                        verticality_x2=False, k_min=12)),
    (4, dict(k_min_search=8)), (5, dict(k_min_search=10, k_min=1))],
    ids=['fixed', 'fixed_no_options', 'search4', 'search5'])
def test_geometric_features_match_jax(neighborhoods, k_step, kw):
    pos, nbr = neighborhoods
    mask = nbr >= 0
    ref = jgeo.geometric_features(jnp.asarray(pos), jnp.asarray(nbr),
                                  jnp.asarray(mask), k_step=k_step, **kw)
    got = tgeo.geometric_features(torch.from_numpy(pos),
                                  torch.from_numpy(nbr),
                                  torch.from_numpy(mask), k_step=k_step,
                                  **kw)
    assert sorted(got) == sorted(ref)
    # rows whose eigenvectors are defined: the JAX planarity and
    # linearity, (l2 - l3) and (l1 - l2) over (l1 + 1e-3) with l_i the
    # square roots of the eigenvalues, above GAP; the normal needs the
    # first gap, the verticality (|V| weighted by the eigenvalues) both
    low = np.asarray(ref['planarity'])[:, 0] > GAP
    both = low & (np.asarray(ref['linearity'])[:, 0] > GAP)
    assert low.mean() > 0.9 and both.mean() > 0.5
    for k, r in ref.items():
        g, r = got[k].numpy(), np.asarray(r)
        assert g.shape == r.shape and g.dtype == np.float32, k
        rows = {'normal': low, 'verticality': both}.get(k, slice(None))
        np.testing.assert_allclose(g[rows], r[rows], rtol=0, atol=FEAT_ATOL,
                                   err_msg=k)


def test_neighborhood_pca_sizes_and_covariance(neighborhoods):
    """Sizes count the valid slots; the eigenvalues are those of the
    n-normalized covariance (numpy LAPACK in f64)."""
    pos, nbr = neighborhoods
    mask = nbr >= 0
    w, _, sizes = tgeo.neighborhood_pca(torch.from_numpy(pos),
                                        torch.from_numpy(nbr),
                                        torch.from_numpy(mask))
    np.testing.assert_array_equal(sizes.numpy(), mask.sum(1))
    i = int(np.argmax(mask.sum(1)))
    p = pos[nbr[i][mask[i]]].astype(np.float64)
    d = p - p.mean(0)
    ref = np.linalg.eigvalsh(d.T @ d / len(p))
    np.testing.assert_allclose(w[i].numpy(), ref, rtol=0,
                               atol=EIG_ATOL * ref.max())
