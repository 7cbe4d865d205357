"""Golden-trajectory tests: the jitted VAMP engine vs. the numpy/scipy
oracle (tests/oracle.py) which replicates the reference's semantics.

Data comes from the single- and multi-cohort simulators (the behavioral
ports of reference simulation/sim_gen_phen*.py). Rademacher probes are
injected identically into both engines so trajectories are deterministic.
CG runs at tight tolerance so both sides solve the linear systems to
convergence and op-order differences cannot flip an iteration count.
"""

import jax.numpy as jnp
import numpy as np
import pytest

from sgvamp.config import VampConfig
from sgvamp.core.operators import DenseLD
from sgvamp.core.prior import PriorState
from sgvamp.core.vamp import VampEngine, VampInputs

from oracle import ReferenceOracle


def _simulate(rng, N, M, K, h2=0.8, lam=0.2):
    """Multi-cohort spike-slab data (behavior of sim_gen_phen_mult.py:28-61:
    shared beta with var h2/cm, per-cohort genotypes, y unstandardized)."""
    cm = int(M * lam)
    beta = np.zeros(M)
    idx = rng.choice(M, size=cm, replace=False)
    beta[idx] = rng.normal(0.0, np.sqrt(h2 / cm), size=cm)
    Rs, rs = [], []
    for _ in range(K):
        X = rng.binomial(2, 0.4, size=(N, M)).astype(np.float64)
        X = (X - X.mean(axis=0)) / X.std(axis=0)
        g = X @ beta
        y = g + rng.normal(0.0, np.sqrt(1.0 - h2), size=N)
        X /= np.sqrt(N)
        rs.append(X.T @ y)
        Rs.append(X.T @ X)
    return np.stack(Rs), np.stack(rs), beta


def _run_both(Rs, rs, Ns, iters, seed=0, s=0.05, prior_update="em",
              learn_gamw=True, lmmse_damp=True, L=2,
              prior_vars=(0.0, 1.0), prior_probs=(0.99, 0.01),
              update_prior_from=1, em_prior_maxit=100):
    K, M = rs.shape
    Nt = float(np.sum(Ns))
    a = np.asarray(Ns, dtype=np.float64) / Nt
    rng = np.random.default_rng(seed + 100)
    u_seq = (rng.integers(0, 2, size=(iters, K, M)) * 2 - 1).astype(np.float64)

    Rs_reg = (1 - s) * Rs + s * np.eye(M)[None]

    oracle = ReferenceOracle(
        [Rs_reg[k] for k in range(K)], rs, a, Ns, Nt,
        prior_vars=list(prior_vars), prior_probs=list(prior_probs),
    )
    ohist = oracle.run(
        iters, u_seq, cg_maxit=2000, cg_rtol=1e-12, learn_gamw=learn_gamw,
        lmmse_damp=lmmse_damp, prior_update=prior_update,
        update_prior_from=update_prior_from, em_prior_maxit=em_prior_maxit,
    )

    cfg = VampConfig(
        cg_maxit=2000, cg_rtol=1e-12, learn_gamw=learn_gamw,
        lmmse_damp=lmmse_damp, prior_update=prior_update, dtype="float64",
        update_prior_from=update_prior_from, em_prior_maxit=em_prior_maxit,
    )
    pc_sigmas = np.asarray(prior_vars[1:]) * Nt
    prior = PriorState.create(1 - prior_probs[0],
                              np.asarray(prior_probs[1:]) / sum(prior_probs[1:]),
                              pc_sigmas)
    inputs = VampInputs(
        op=DenseLD(mats=jnp.asarray(Rs), s=s),
        r=jnp.asarray(rs), a=jnp.asarray(a), N=jnp.asarray(Ns, dtype=np.float64),
    )
    engine = VampEngine(inputs, cfg, prior)
    hist = engine.run(iters, fixed_u=u_seq)
    return ohist, hist


# Both sides solve CG to rtol=1e-12, so remaining differences are op-order
# rounding amplified over iterations.
TRAJ_RTOL = 1e-6


@pytest.mark.parametrize(
    "K,prior_update,learn_gamw,lmmse_damp",
    [
        (1, "em", True, True),
        (1, None, True, False),
        (1, "mle", False, True),
        (2, "em", True, True),
        (3, "mle", True, True),
    ],
)
def test_trajectory_matches_oracle(K, prior_update, learn_gamw, lmmse_damp):
    rng = np.random.default_rng(42)
    N, M, iters = 800, 100, 6
    Rs, rs, beta = _simulate(rng, N, M, K)
    Ns = np.full(K, N, dtype=np.float64)
    ohist, hist = _run_both(Rs, rs, Ns, iters, prior_update=prior_update,
                            learn_gamw=learn_gamw, lmmse_damp=lmmse_damp)

    for it in range(iters):
        o = ohist["xhat1"][it]
        g = hist["xhat1"][it]
        scale = np.linalg.norm(o) + 1e-30
        np.testing.assert_allclose(g, o, atol=TRAJ_RTOL * scale,
                                   err_msg=f"xhat1 mismatch at iteration {it}")
        for k in range(K):
            orow = np.asarray(ohist["params"][it][k], dtype=np.float64)
            grow = np.asarray(hist["params"][it][k], dtype=np.float64)
            np.testing.assert_allclose(
                grow, orow, rtol=1e-6,
                err_msg=f"params mismatch at it={it} cohort={k}",
            )


@pytest.mark.parametrize("upf,em_maxit", [(3, 100), (1, 2), (0, 100)])
def test_prior_schedule_knobs_match_oracle(upf, em_maxit):
    """update_prior_from gating and a capped EM sweep budget must follow
    the reference's exact schedule (reference sgvamp.py:242-259)."""
    rng = np.random.default_rng(17)
    N, M, iters = 800, 80, 5
    Rs, rs, beta = _simulate(rng, N, M, 1)
    Ns = np.asarray([float(N)])
    ohist, hist = _run_both(Rs, rs, Ns, iters, update_prior_from=upf,
                            em_prior_maxit=em_maxit)
    for it in range(iters):
        o, g = ohist["xhat1"][it], hist["xhat1"][it]
        np.testing.assert_allclose(g, o, atol=TRAJ_RTOL * np.linalg.norm(o))
        np.testing.assert_allclose(float(hist["params"][it][0][6]),
                                   ohist["params"][it][0][6], rtol=1e-8)


def test_trajectory_matches_oracle_mixture_l3():
    rng = np.random.default_rng(7)
    N, M, K, iters = 800, 100, 2, 5
    Rs, rs, beta = _simulate(rng, N, M, K)
    Ns = np.asarray([N, N], dtype=np.float64)
    ohist, hist = _run_both(
        Rs, rs, Ns, iters, prior_update="em", L=3,
        prior_vars=(0.0, 0.5, 2.0), prior_probs=(0.95, 0.03, 0.02),
    )
    for it in range(iters):
        o, g = ohist["xhat1"][it], hist["xhat1"][it]
        np.testing.assert_allclose(g, o, atol=TRAJ_RTOL * np.linalg.norm(o))


def test_unequal_cohort_sizes():
    """Cohort weights a_k = N_k/Nt and per-cohort N in the gamw update."""
    rng = np.random.default_rng(11)
    M, iters = 80, 4
    Ns = np.asarray([600.0, 1200.0])
    Rs, rs = [], []
    _, _, beta = _simulate(rng, 100, M, 1)
    all_R, all_r = [], []
    for N in Ns:
        Rk, rk, _ = _simulate(rng, int(N), M, 1)
        all_R.append(Rk[0]); all_r.append(rk[0])
    Rs, rs = np.stack(all_R), np.stack(all_r)
    ohist, hist = _run_both(Rs, rs, Ns, iters)
    for it in range(iters):
        o, g = ohist["xhat1"][it], hist["xhat1"][it]
        np.testing.assert_allclose(g, o, atol=TRAJ_RTOL * np.linalg.norm(o))
        for k in range(2):
            np.testing.assert_allclose(
                np.asarray(hist["params"][it][k]),
                np.asarray(ohist["params"][it][k]), rtol=1e-6)


def test_fused_scan_matches_host_loop():
    """run_scan (one XLA program) must produce the same final state as the
    per-iteration host loop with the same PRNG seed."""
    rng = np.random.default_rng(3)
    N, M, K, iters = 500, 64, 1, 4
    Rs, rs, _ = _simulate(rng, N, M, K)
    Ns = np.full(K, N, dtype=np.float64)
    Nt = float(Ns.sum())
    cfg = VampConfig(cg_maxit=500, cg_rtol=1e-10, dtype="float64")
    prior = PriorState.create(0.01, [1.0], [1.0 * Nt])
    inputs = VampInputs(op=DenseLD(mats=jnp.asarray(Rs), s=0.05),
                        r=jnp.asarray(rs), a=jnp.asarray(Ns / Nt),
                        N=jnp.asarray(Ns))
    engine = VampEngine(inputs, cfg, prior)
    hist = engine.run(iters, seed=123)
    final_scan, aux = engine.run_scan(iters, seed=123)
    np.testing.assert_allclose(np.asarray(final_scan.xhat1),
                               hist["xhat1"][-1], rtol=1e-10)
    np.testing.assert_allclose(np.asarray(aux.xhat1[-1]),
                               hist["xhat1"][-1], rtol=1e-10)
