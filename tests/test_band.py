"""Band-storage simulator and BandedLD.from_band tests, including the
padded-vs-dense engine equivalence that exercises the marker masks."""

import jax.numpy as jnp
import numpy as np

from sgvamp import PriorState, VampConfig, VampEngine, VampInputs
from sgvamp.core.operators import BandedLD, DenseLD
from sgvamp.data.simulate import band_matvec, band_to_dense, simulate_ld_band


def test_simulated_band_is_spd_correlation():
    band, r, x0 = simulate_ld_band(10000, 256, bandwidth=32,
                                   rng=np.random.default_rng(0),
                                   dtype=np.float64)
    R = band_to_dense(band)
    np.testing.assert_allclose(R, R.T, atol=1e-15)
    np.testing.assert_allclose(np.diag(R), 1.0, atol=1e-12)
    assert np.linalg.eigvalsh(R).min() > 0


def test_band_matvec_matches_dense():
    rng = np.random.default_rng(1)
    band, _, _ = simulate_ld_band(5000, 200, bandwidth=16, rng=rng,
                                  dtype=np.float64)
    R = band_to_dense(band)
    x = rng.normal(size=200)
    np.testing.assert_allclose(band_matvec(band, x), R @ x, rtol=1e-10)


def test_from_band_matches_dense_with_padding():
    rng = np.random.default_rng(2)
    M, B = 300, 64  # pads to 320
    band, _, _ = simulate_ld_band(5000, M, bandwidth=32, rng=rng,
                                  dtype=np.float64)
    R = band_to_dense(band)
    op = BandedLD.from_band(band, block_size=B)
    assert op.M == 320
    x = rng.normal(size=M)
    xp = np.zeros(op.M)
    xp[:M] = x
    got = np.asarray(op.matvec(jnp.asarray(xp)[None]))[0]
    np.testing.assert_allclose(got[:M], R @ x, rtol=1e-8)
    np.testing.assert_allclose(got[M:], xp[M:], atol=1e-12)  # identity pad


def test_padded_banded_engine_matches_dense_engine():
    """Full engine equivalence: banded op with padding + mask vs dense op
    at exact M, with injected probes. Guards every masked reduction."""
    rng = np.random.default_rng(3)
    N, M, lam, h2, iters = 20000, 200, 0.1, 0.7, 4
    band, r, x0 = simulate_ld_band(N, M, bandwidth=24, rng=rng,
                                   dtype=np.float64, h2=h2, lam=lam)
    R = band_to_dense(band)
    cm = int(M * lam)
    u = (rng.integers(0, 2, size=(iters, 1, M)) * 2 - 1).astype(np.float64)

    cfg = VampConfig(prior_update="em", dtype="float64", cg_maxit=300,
                     cg_rtol=1e-12, lmmse_damp=True)
    prior = PriorState.create(lam, [1.0], [h2 / cm * N])

    dense_inputs = VampInputs(op=DenseLD(mats=jnp.asarray(R)[None]),
                              r=jnp.asarray(r, jnp.float64)[None],
                              a=jnp.asarray([1.0]), N=jnp.asarray([float(N)]))
    h_dense = VampEngine(dense_inputs, cfg, prior).run(iters, fixed_u=u)

    op = BandedLD.from_band(band, block_size=64)  # pads 200 -> 256
    Mp = op.M
    mask = np.zeros(Mp)
    mask[:M] = 1.0
    rp = np.zeros(Mp)
    rp[:M] = r
    up = np.zeros((iters, 1, Mp))
    up[:, :, :M] = u
    band_inputs = VampInputs(op=op, r=jnp.asarray(rp)[None],
                             a=jnp.asarray([1.0]), N=jnp.asarray([float(N)]),
                             mask=jnp.asarray(mask))
    h_band = VampEngine(band_inputs, cfg, prior).run(iters, fixed_u=up, M_out=M)

    for it in range(iters):
        np.testing.assert_allclose(h_band["xhat1"][it], h_dense["xhat1"][it],
                                   rtol=1e-8, atol=1e-10)
        np.testing.assert_allclose(np.asarray(h_band["params"][it]),
                                   np.asarray(h_dense["params"][it]), rtol=1e-7)
