"""Denoiser unit tests: oracle match, autodiff cross-check, stability.

The reference's per-marker denoiser pair (reference src/sgvamp.py:93-114)
has no tests; here the vectorized version is checked against (a) a direct
per-marker numpy transliteration of the reference formulas, (b) jax.grad
of the posterior mean, and (c) extreme inputs where the unshifted math
would overflow (the reference flags its single-cohort variant as
"not numerically stable", src/sgvamp.py:78).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from sgvamp.core.denoiser import combine_cohorts, posterior_mean_and_slope


def _per_marker_reference(rs, gam1s, a, lam, omegas, sigmas):
    """Direct per-marker transliteration of reference denoiser_meta
    (src/sgvamp.py:93-102) and der_denoiser_meta (:104-114) for cohort 0."""
    s2 = 1.0 / (np.sum(a * gam1s) + 1.0 / sigmas)
    mu = np.inner(rs, a * gam1s) * s2
    mi = np.argmax(mu * mu / s2)
    EXP = np.exp(0.5 * (mu * mu * s2[mi] - mu[mi] ** 2 * s2) / (s2 * s2[mi]))
    num = lam * np.sum(omegas * EXP * mu * np.sqrt(s2 / sigmas))
    EXP2 = np.exp(-0.5 * mu[mi] ** 2 / s2[mi])
    den = (1 - lam) * EXP2 + lam * np.sum(omegas * EXP * np.sqrt(s2 / sigmas))
    xhat = num / den
    dnum = lam * np.sum(omegas * EXP * (mu * mu + s2) * a[0] * gam1s[0] * np.sqrt(s2 / sigmas))
    dden = lam * np.sum(omegas * mu * EXP * a[0] * gam1s[0] * np.sqrt(s2 / sigmas))
    der = (dnum * den - dden * num) / (den * den)
    return xhat, der


@pytest.mark.parametrize("K,L", [(1, 2), (3, 2), (2, 4)])
def test_matches_per_marker_reference_formulas(K, L):
    rng = np.random.default_rng(0)
    M = 50
    r1s = rng.normal(size=(K, M)) * 3.0
    gam1s = rng.uniform(0.5, 2.0, size=K)
    a = rng.uniform(0.2, 1.0, size=K)
    a /= a.sum()
    lam = 0.3
    omegas = rng.uniform(0.5, 1.0, size=L - 1)
    omegas /= omegas.sum()
    sigmas = rng.uniform(0.5, 5.0, size=L - 1)

    b, A, c = combine_cohorts(jnp.asarray(r1s), jnp.asarray(gam1s), jnp.asarray(a))
    xhat, dxdb = posterior_mean_and_slope(
        b, A, jnp.asarray(lam), jnp.asarray(omegas), jnp.asarray(sigmas)
    )
    der0 = np.asarray(dxdb) * float(c[0])

    for j in range(M):
        x_ref, d_ref = _per_marker_reference(r1s[:, j], gam1s, a, lam, omegas, sigmas)
        np.testing.assert_allclose(float(xhat[j]), x_ref, rtol=1e-12)
        np.testing.assert_allclose(der0[j], d_ref, rtol=1e-10, atol=1e-14)


def test_slope_matches_autodiff():
    rng = np.random.default_rng(1)
    K, M, L = 2, 40, 3
    r1s = jnp.asarray(rng.normal(size=(K, M)) * 2.0)
    gam1s = jnp.asarray(rng.uniform(0.5, 2.0, size=K))
    a = jnp.asarray([0.6, 0.4])
    lam, omegas = jnp.asarray(0.2), jnp.asarray([0.7, 0.3])
    sigmas = jnp.asarray([1.0, 4.0])

    b, A, c = combine_cohorts(r1s, gam1s, a)
    _, dxdb = posterior_mean_and_slope(b, A, lam, omegas, sigmas)

    def mean_j(bj):
        xh, _ = posterior_mean_and_slope(bj[None], A, lam, omegas, sigmas)
        return xh[0]

    ad = jax.vmap(jax.grad(mean_j))(b)
    np.testing.assert_allclose(np.asarray(dxdb), np.asarray(ad), rtol=1e-9, atol=1e-12)


def test_numerically_stable_at_extremes():
    """Large |b| would overflow exp(score) without the max shift."""
    b = jnp.asarray([0.0, 1e3, -1e3, 1e6])
    A = jnp.asarray(1.0)
    xhat, dxdb = posterior_mean_and_slope(
        b, A, jnp.asarray(0.5), jnp.asarray([1.0]), jnp.asarray([2.0])
    )
    assert np.all(np.isfinite(np.asarray(xhat)))
    assert np.all(np.isfinite(np.asarray(dxdb)))
    # In the strong-signal limit the posterior mean approaches the slab
    # LMMSE shrinkage s2 * b = b * sigma/(A*sigma+1).
    np.testing.assert_allclose(float(xhat[3]) / 1e6, 2.0 / 3.0, rtol=1e-6)
