"""Per-point geometric features on the host: a copy of
`geometric_features_np` of the JAX package's `ops/geometry.py` (its
numpy half; the jax half stays there).
"""
import numpy as np

from .native import eigen_features

__all__ = ['geometric_features_np']


def geometric_features_np(
        xyz, nbr_idx, nbr_mask, k_min=5, k_step=-1, k_min_search=25,
        add_self=True, orient_normal_z=True, verticality_x2=True,
        chunk=200_000, raw_invalid=False):
    """Neighborhood-PCA features per point: linearity, planarity,
    scattering, verticality, curvature, length, surface, volume and the
    normal (SPG formulas, covariance normalized by n, sqrt eigenvalues,
    x2 verticality, Z+ normals). Chunked to bound the buffers.

    With `k_step < 0` the PCA runs in the native kernel over the whole
    table (self-loop added inside when `add_self`). With `k_step >= 0`
    each point keeps the neighborhood size, from `k_min_search` up in
    steps of `k_step`, of least eigenentropy (numpy PCA).

    `raw_invalid=True` promises `nbr_idx` already carries -1 at every
    invalid slot (the KNN output convention), so the table goes to the
    native kernel with one int32 cast.
    """
    xyz = np.asarray(xyz, np.float32)
    nbr_idx = np.asarray(nbr_idx)
    nbr_mask = np.asarray(nbr_mask, bool)
    N = xyz.shape[0]

    native_out = None
    if k_step < 0:
        tab = (nbr_idx if raw_invalid
               else np.where(nbr_mask, nbr_idx, -1))
        native_out = eigen_features(xyz, tab, add_self=add_self)
    elif add_self:
        nbr_idx = np.concatenate(
            [np.arange(N, dtype=nbr_idx.dtype)[:, None], nbr_idx], 1)
        nbr_mask = np.concatenate(
            [np.ones((N, 1), bool), nbr_mask], 1)
    K = nbr_idx.shape[1]

    def pca(idx_c, mask_c, xyz_full):
        m = mask_c.astype(np.float32)[..., None]
        p = xyz_full[idx_c] * m
        n = np.maximum(m.sum(1), 1.0)
        mean = p.sum(1) / n
        d = (p - mean[:, None, :]) * m
        cov = np.einsum('nki,nkj->nij', d, d,
                        optimize=True) / n[..., None]
        w, V = np.linalg.eigh(cov.astype(np.float64))
        return (np.maximum(w, 0).astype(np.float32),
                V.astype(np.float32),
                mask_c.sum(1).astype(np.int32))

    out = {k: [] for k in ('linearity', 'planarity', 'scattering',
                           'verticality', 'curvature', 'length',
                           'surface', 'volume', 'normal')}
    for s in range(0, N, chunk):
        e = min(s + chunk, N)
        if native_out is not None:
            w, V, sizes = (native_out[0][s:e], native_out[1][s:e],
                           native_out[2][s:e])
        else:
            idx_c = np.clip(nbr_idx[s:e], 0, N - 1)
            mask_c = nbr_mask[s:e]
            k0 = max(k_min, k_min_search)
            ks = [k for k in range(k0, K + 1)
                  if k == k0 or k % k_step == 0 or k == K]
            w, V, sizes = pca(idx_c[:, :k0], mask_c[:, :k0], xyz)
            ent = _eigenentropy_np(w)
            for k in ks[1:]:
                wk, Vk, sk = pca(idx_c[:, :k], mask_c[:, :k], xyz)
                entk = _eigenentropy_np(wk)
                b = entk < ent
                w[b], V[b], sizes[b], ent[b] = wk[b], Vk[b], sk[b], \
                    entk[b]

        l1 = np.sqrt(w[:, 2])
        l2 = np.sqrt(w[:, 1])
        l3 = np.sqrt(w[:, 0])
        keep = (sizes >= k_min)[:, None].astype(np.float32)
        unary = (np.abs(V) * w[:, None, :]).sum(2)
        vert = unary[:, 2] / (np.linalg.norm(unary, axis=1) + 1e-8)
        normal = V[:, :, 0]
        if orient_normal_z:
            flip = normal[:, 2:3] < 0
            normal = np.where(flip, -normal, normal)
        if verticality_x2:
            vert = vert * 2
        vals = dict(
            linearity=((l1 - l2) / (l1 + 1e-3))[:, None],
            planarity=((l2 - l3) / (l1 + 1e-3))[:, None],
            scattering=(l3 / (l1 + 1e-3))[:, None],
            verticality=vert[:, None],
            curvature=(l3 / (l1 + l2 + l3 + 1e-3))[:, None],
            length=l1[:, None],
            surface=np.sqrt(l1 * l2 + 1e-6)[:, None],
            volume=np.power(l1 * l2 * l3 + 1e-9, 1 / 3)[:, None],
            normal=normal)
        for k2, v in vals.items():
            out[k2].append((v * keep).astype(np.float32))
    return {k: np.concatenate(v) for k, v in out.items()}


def _eigenentropy_np(w, epsilon=1e-3):
    e = w / (w.sum(1, keepdims=True) + epsilon)
    return (-e * np.log(e + epsilon)).sum(1)
