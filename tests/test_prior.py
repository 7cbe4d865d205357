"""Prior-learning tests: EM against a direct numpy transliteration, the EM
convergence loop, and the Newton MLE solve against scipy.optimize.fsolve
(the reference's solver, src/sgvamp.py:180) including failure semantics."""

import jax.numpy as jnp
import numpy as np
import pytest
import scipy.optimize

from sgvamp.core.prior import PriorState, em_loop, em_update, mle_update


def _problem(rng, K=2, M=120, L=3):
    r1s = rng.normal(size=(K, M)) * 2.0
    gam1s = rng.uniform(0.5, 2.0, size=K)
    a = rng.uniform(0.5, 1.0, size=K)
    a /= a.sum()
    lam = 0.25
    omegas = rng.uniform(0.5, 1.0, size=L - 1)
    omegas /= omegas.sum()
    sigmas = rng.uniform(1.0, 6.0, size=L - 1)
    return r1s, gam1s, a, lam, omegas, sigmas


def _em_reference(r1s, gam1s, a, lam, omegas, sigmas):
    """Transliteration of reference prior_update_em (src/sgvamp.py:116-136)."""
    K, M = r1s.shape
    Lm1 = len(sigmas)
    pv = sigmas.reshape(1, 1, Lm1)
    g = gam1s.reshape(K, 1, 1)
    ginv = 1.0 / g
    r = r1s.reshape(K, M, 1)
    exp_max = (-(r ** 2) / 2 / (pv + ginv)).max(axis=2).reshape(K, M, 1)
    xi = lam * omegas.reshape(1, 1, Lm1) * np.exp(-(r ** 2) / 2 / (pv + ginv) - exp_max) / np.sqrt(ginv + pv)
    sum_xi = xi.sum(axis=2).reshape(K, M, 1)
    xi_t = xi / sum_xi
    pi = 1.0 / (1.0 + (1 - lam) * np.exp(-(r ** 2) / 2 * g - exp_max) / np.sqrt(ginv) / sum_xi)
    new_lam = np.mean(np.average(pi, axis=0, weights=a))
    new_om = np.sum(pi * xi_t * a.reshape(K, 1, 1), axis=(0, 1)) / np.sum(pi * a.reshape(K, 1, 1), axis=(0, 1))
    return new_lam, new_om


def test_em_update_matches_reference_formulas():
    rng = np.random.default_rng(0)
    r1s, gam1s, a, lam, omegas, sigmas = _problem(rng)
    want_lam, want_om = _em_reference(r1s, gam1s, a, lam, omegas, sigmas)
    got_lam, got_om = em_update(
        jnp.asarray(r1s), jnp.asarray(gam1s), jnp.asarray(a),
        jnp.asarray(lam), jnp.asarray(omegas), jnp.asarray(sigmas),
    )
    np.testing.assert_allclose(float(got_lam), want_lam, rtol=1e-12)
    np.testing.assert_allclose(np.asarray(got_om), want_om, rtol=1e-12)


def test_em_loop_matches_reference_loop():
    """The while_loop must stop at the same sweep as the reference's
    python loop (break after an update with rel err < 1e-6)."""
    rng = np.random.default_rng(1)
    r1s, gam1s, a, lam, omegas, sigmas = _problem(rng, M=200)

    ref_lam, ref_om = lam, omegas.copy()
    sweeps_ref = 0
    for _ in range(100):
        old_om, old_lam = ref_om.copy(), ref_lam
        ref_lam, ref_om = _em_reference(r1s, gam1s, a, ref_lam, ref_om, sigmas)
        sweeps_ref += 1
        om_err = np.linalg.norm(ref_om - old_om) / np.linalg.norm(old_om)
        lam_err = abs(ref_lam - old_lam) / ref_lam
        if om_err < 1e-6 and lam_err < 1e-6:
            break

    got_lam, got_om, sweeps, _ = em_loop(
        jnp.asarray(r1s), jnp.asarray(gam1s), jnp.asarray(a),
        jnp.asarray(lam), jnp.asarray(omegas), jnp.asarray(sigmas),
        maxit=100,
    )
    assert int(sweeps) == sweeps_ref
    np.testing.assert_allclose(float(got_lam), ref_lam, rtol=1e-10)
    np.testing.assert_allclose(np.asarray(got_om), ref_om, rtol=1e-10)


def _fsolve_reference(r1s, gam1s, a, lam, omegas, sigmas, gam_init=1.0):
    """fsolve on the reference KKT system (src/sgvamp.py:139-194)."""
    L = len(sigmas) + 1
    omega0 = np.concatenate([[1.0 - lam], lam * omegas])
    sigma2 = np.concatenate([[1e-16], sigmas])
    v = sigma2[None, None, :] + (1.0 / gam1s)[:, None, None]
    E = -(r1s ** 2)[:, :, None] / (2.0 * v)
    m = E.max()
    probs = np.exp(E - m) / np.sqrt(v)

    def kkt(x):
        omega, gam = x[:L], x[L]
        den = probs @ omega
        y = np.empty(L + 1)
        y[:L] = (a[:, None, None] * probs / den[:, :, None]).sum(axis=(0, 1)) \
            + (omega0 - 1.0) / omega + gam
        y[L] = omega.sum() - 1.0
        return y

    x0 = np.concatenate([omega0, [gam_init]])
    x, _, ier, _ = scipy.optimize.fsolve(kkt, x0, full_output=True)
    return x, ier


def _vamp_like_state(seed, K=2, M=300, L=2):
    """r1 = x + noise at precision gam1 - the state shape MLE sees in a run."""
    rng = np.random.default_rng(seed)
    sigmas = np.linspace(1.0, 4.0, L - 1)
    x = np.where(rng.random(M) < 0.2, rng.normal(0, 1.0, M), 0.0)
    gam1s = rng.uniform(0.5, 2.0, K)
    r1s = x[None, :] + rng.normal(size=(K, M)) / np.sqrt(gam1s)[:, None]
    a = np.full(K, 1.0 / K)
    omegas = np.ones(L - 1) / (L - 1)
    return r1s, gam1s, a, 0.25, omegas, sigmas


@pytest.mark.parametrize("seed", [1, 2, 4])
def test_mle_matches_fsolve_fixed_point(seed):
    L = 2
    r1s, gam1s, a, lam, omegas, sigmas = _vamp_like_state(seed, L=L)
    x_ref, ier = _fsolve_reference(r1s, gam1s, a, lam, omegas, sigmas)
    assert ier == 1 and np.all(x_ref[:L] > 0)
    w = x_ref[:L] / x_ref[:L].sum()
    want_lam = 1.0 - w[0]
    want_om = w[1:] / w[1:].sum()

    prior = PriorState.create(lam, omegas, sigmas)
    new = mle_update(jnp.asarray(r1s), jnp.asarray(gam1s), jnp.asarray(a), prior)
    np.testing.assert_allclose(float(new.lam), want_lam, rtol=1e-6)
    np.testing.assert_allclose(np.asarray(new.omegas), want_om, rtol=1e-6)
    np.testing.assert_allclose(float(new.mle_gam), x_ref[L], rtol=1e-5)
    assert bool(new.mle_gam_valid)


def test_mle_l3_guarded():
    """On an ill-posed L=3 problem (close slab variances on random data,
    where fsolve fails with ier 4/5 or negative weights), the update must
    either be rejected (prior unchanged) or produce a genuine positive
    normalized root with a small KKT residual - never a garbage update."""
    r1s, gam1s, a, lam, omegas, sigmas = _vamp_like_state(0, L=3)
    prior = PriorState.create(lam, omegas, sigmas)
    new = mle_update(jnp.asarray(r1s), jnp.asarray(gam1s), jnp.asarray(a), prior)
    if bool(new.mle_gam_valid):
        w = np.concatenate([[1 - float(new.lam)],
                            float(new.lam) * np.asarray(new.omegas)])
        assert np.all(w > 0)
        np.testing.assert_allclose(w.sum(), 1.0, rtol=1e-10)
    else:
        np.testing.assert_allclose(float(new.lam), lam)
        np.testing.assert_allclose(np.asarray(new.omegas), omegas)


def test_mle_failure_skips_update():
    """Degenerate inputs (all-zero r1s with a huge precision) should leave
    the prior untouched, mirroring the reference's reject path (:182-189)."""
    K, M = 1, 20
    r1s = jnp.zeros((K, M))
    gam1s = jnp.asarray([1e18])
    a = jnp.asarray([1.0])
    prior = PriorState.create(0.25, [1.0], [1e-30])
    new = mle_update(r1s, gam1s, a, prior, maxit=5, tol=1e-30)
    # Either the solve legitimately converges (then weights are positive and
    # finite) or the prior is unchanged; with these inputs Newton cannot meet
    # tol in 5 iterations, so expect the unchanged path.
    np.testing.assert_allclose(float(new.lam), 0.25)
    np.testing.assert_allclose(np.asarray(new.omegas), [1.0])


# ---------------------------------------------------------------------------
# MLE robustness stress tests: near-singular KKT systems where MINPACK
# hybrd (the reference's fsolve) converges; the LM-damped Newton solve must
# converge to the same fixed point (or, at worst, cleanly skip - but these
# cases are chosen so fsolve converges, and we assert convergence).
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("gap", [1e-6, 1e-9])
def test_mle_near_degenerate_components(gap):
    """Two slab components with nearly identical variances make the KKT
    Jacobian nearly singular in the (omega_1, omega_2) subspace: their
    probs columns are almost collinear. Plain Newton's J-solve blows up;
    LM damping must still converge to the fsolve fixed point."""
    rng = np.random.default_rng(8)
    K, M, L = 2, 300, 3
    sigmas = np.asarray([2.0, 2.0 * (1.0 + gap)])
    x = np.where(rng.random(M) < 0.2, rng.normal(0, 1.2, M), 0.0)
    gam1s = rng.uniform(0.5, 2.0, K)
    r1s = x[None, :] + rng.normal(size=(K, M)) / np.sqrt(gam1s)[:, None]
    a = np.full(K, 0.5)
    lam, omegas = 0.25, np.asarray([0.5, 0.5])

    x_ref, ier = _fsolve_reference(r1s, gam1s, a, lam, omegas, sigmas)
    assert ier == 1 and np.all(x_ref[:L] > 0), "fsolve itself should converge"
    w = x_ref[:L] / x_ref[:L].sum()

    prior = PriorState.create(lam, omegas, sigmas)
    new = mle_update(jnp.asarray(r1s), jnp.asarray(gam1s), jnp.asarray(a), prior)
    assert bool(new.mle_last_ok), "LM Newton must converge where fsolve does"
    np.testing.assert_allclose(float(new.lam), 1.0 - w[0], rtol=1e-5)
    # the two near-identical components' individual weights are genuinely
    # ill-determined (that's the near-singularity); their sum is not
    np.testing.assert_allclose(float(jnp.sum(new.omegas)), 1.0, rtol=1e-12)


def test_mle_extreme_gam1_spread():
    """gam1 spread over 8 orders of magnitude between cohorts: one cohort's
    probs are nearly constant across components, flattening the Jacobian."""
    rng = np.random.default_rng(21)
    K, M, L = 2, 300, 2
    sigmas = np.asarray([1.5])
    x = np.where(rng.random(M) < 0.2, rng.normal(0, 1.0, M), 0.0)
    gam1s = np.asarray([1e-6, 1e2])
    r1s = x[None, :] + rng.normal(size=(K, M)) / np.sqrt(gam1s)[:, None]
    a = np.asarray([0.5, 0.5])
    lam, omegas = 0.25, np.asarray([1.0])

    x_ref, ier = _fsolve_reference(r1s, gam1s, a, lam, omegas, sigmas)
    prior = PriorState.create(lam, omegas, sigmas)
    new = mle_update(jnp.asarray(r1s), jnp.asarray(gam1s), jnp.asarray(a), prior)
    if ier == 1 and np.all(x_ref[:L] > 0):
        w = x_ref[:L] / x_ref[:L].sum()
        assert bool(new.mle_last_ok)
        np.testing.assert_allclose(float(new.lam), 1.0 - w[0], rtol=1e-5)
    else:
        # fsolve rejected too: our reject path must leave the prior alone
        assert not bool(new.mle_last_ok) or np.all(np.asarray(new.omegas) > 0)


def test_mle_singular_jacobian_no_nan():
    """EXACTLY duplicated components: the Jacobian is singular by
    construction. The solve must never poison the prior with NaN - either
    it converges through LM damping or it skips."""
    rng = np.random.default_rng(3)
    K, M = 1, 200
    sigmas = np.asarray([1.0, 1.0])   # identical
    r1s = rng.normal(size=(K, M)) * 2.0
    gam1s = np.asarray([1.0])
    a = np.asarray([1.0])
    prior = PriorState.create(0.3, np.asarray([0.5, 0.5]), sigmas)
    new = mle_update(jnp.asarray(r1s), jnp.asarray(gam1s), jnp.asarray(a), prior)
    assert np.isfinite(float(new.lam))
    assert np.all(np.isfinite(np.asarray(new.omegas)))
    assert np.all(np.asarray(new.omegas) >= 0)


def test_kkt_closed_form_jacobian_matches_autodiff():
    """The hand-derived KKT Jacobian (one extra einsum over (K, M, L))
    must equal jax.jacfwd of the residual - and the fused function's
    residual must equal the standalone one."""
    import jax

    from sgvamp.core.prior import _kkt_residual, _kkt_residual_and_jac

    rng = np.random.default_rng(0)
    K, M, L = 3, 64, 4
    for use_mask in (False, True):
        log_probs = jnp.asarray(rng.normal(size=(K, M, L)) - 1.0)
        a = jnp.asarray(rng.dirichlet(np.ones(K)))
        omega0 = jnp.asarray(rng.dirichlet(np.ones(L)))
        mask = None
        if use_mask:
            mask = jnp.asarray((rng.random(M) < 0.8).astype(np.float64))
        x = jnp.concatenate([omega0 * 0.9 + 0.02,
                             jnp.asarray([0.7])])
        y, J = _kkt_residual_and_jac(x, log_probs, a, omega0, mask)
        y_ref = _kkt_residual(x, log_probs, a, omega0, mask)
        J_ref = jax.jacfwd(
            lambda z: _kkt_residual(z, log_probs, a, omega0, mask))(x)
        np.testing.assert_allclose(np.asarray(y), np.asarray(y_ref),
                                   rtol=1e-12, atol=1e-14)
        np.testing.assert_allclose(np.asarray(J), np.asarray(J_ref),
                                   rtol=1e-9, atol=1e-12,
                                   err_msg=f"mask={use_mask}")


def test_mle_step_cost_within_2x_of_em_at_scale():
    """With the closed-form Jacobian, one MLE prior update costs the same
    order as the EM loop at large M (the jacfwd version re-evaluated the
    (K, M, L) residual L+1 times per Newton step and dominated step time).
    Wall-clock on a realistic sparse-signal input at M=262144; the 3x
    bound is the ~2x target with shared-host headroom."""
    import time

    import jax

    K, M = 1, 262144
    rng = np.random.default_rng(0)
    beta = np.where(rng.random(M) < 0.01, rng.normal(0, 3.0, M), 0.0)
    r1s = jnp.asarray((beta + rng.normal(0, 0.5, M))[None])
    gam1s = jnp.asarray([4.0])
    a = jnp.asarray([1.0])
    prior = PriorState.create(0.01, [1.0], [9.0])

    em = jax.jit(lambda r, g: em_loop(r, g, a, prior.lam, prior.omegas,
                                      prior.sigmas, 100))
    ml = jax.jit(lambda r, g, p: mle_update(r, g, a, p))
    lam, _, sweeps, _ = em(r1s, gam1s)
    out = ml(r1s, gam1s, prior)
    assert bool(out.mle_last_ok)
    # both learn the same sparsity on this input (fixed-point agreement)
    np.testing.assert_allclose(float(out.lam), float(lam), rtol=5e-3)

    def wall(f, *args):
        jax.block_until_ready(f(*args))  # warm
        n, t0 = 5, time.perf_counter()
        for _ in range(n):
            jax.block_until_ready(f(*args))
        return (time.perf_counter() - t0) / n

    t_em = wall(em, r1s, gam1s)
    t_ml = wall(ml, r1s, gam1s, prior)
    assert t_ml < 3.0 * t_em, (
        f"MLE step {t_ml * 1e3:.1f} ms vs EM loop {t_em * 1e3:.1f} ms "
        f"(ratio {t_ml / t_em:.2f} > 3)")


def test_mle_accepts_at_large_M_f32():
    """The MLE acceptance gate scales with M: the KKT residual's gradient
    term sums over markers (O(M) magnitude), so an absolute 1e-6 gate
    demanded ~1e-11 relative accuracy at biobank M and every f32 update
    was rejected (observed at M=512k in f32). A realistic f32 problem at
    M=65536 must ACCEPT and agree with EM's sparsity estimate."""
    K, M = 1, 65536
    rng = np.random.default_rng(0)
    beta = np.where(rng.random(M) < 0.01, rng.normal(0, 3.0, M), 0.0)
    r1s = jnp.asarray((beta + rng.normal(0, 0.5, M))[None], jnp.float32)
    gam1s = jnp.asarray([4.0], jnp.float32)
    a = jnp.asarray([1.0], jnp.float32)
    prior = PriorState.create(0.02, [1.0], [9.0], dtype=jnp.float32)
    new = mle_update(r1s, gam1s, a, prior)
    assert bool(new.mle_last_ok), "large-M f32 MLE update rejected"
    lam_em, _, _, _ = em_loop(r1s, gam1s, a, prior.lam, prior.omegas,
                              prior.sigmas, 100)
    np.testing.assert_allclose(float(new.lam), float(lam_em), rtol=2e-2)
