"""Precision studies and failure-detection tests.

f32 is the production accelerator dtype; these tests document how closely f32
trajectories track f64 on a well-posed problem (the fidelity claim the
README makes) and that the non-finite abort guard fires.
"""

import jax.numpy as jnp
import numpy as np

from sgvamp import PriorState, VampConfig, VampEngine, VampInputs
from sgvamp.core.operators import BandedLD, DenseLD
from sgvamp.data.simulate import simulate_ld_band, simulate_single


def test_f32_tracks_f64_trajectory():
    rng = np.random.default_rng(0)
    N, M, lam, h2, iters = 30000, 1024, 0.05, 0.7, 5
    band, r, x0 = simulate_ld_band(N, M, bandwidth=64, rng=rng,
                                   dtype=np.float64, h2=h2, lam=lam)
    u = (rng.integers(0, 2, size=(iters, 1, M)) * 2 - 1).astype(np.float64)
    hists = {}
    for dt in ["float64", "float32"]:
        op = BandedLD.from_band(band.astype(dt), block_size=128)
        cfg = VampConfig(prior_update="em", dtype=dt, cg_maxit=400,
                         cg_rtol=1e-6, lmmse_damp=True)
        prior = PriorState.create(lam, [1.0], [h2 / int(M * lam) * N])
        inputs = VampInputs(op=op, r=jnp.asarray(r, dt)[None],
                            a=jnp.asarray([1.0], dt),
                            N=jnp.asarray([float(N)], dt))
        hists[dt] = VampEngine(inputs, cfg, prior).run(iters, fixed_u=u)
    for it in range(iters):
        a = hists["float64"]["xhat1"][it]
        b = hists["float32"]["xhat1"][it]
        rel = np.linalg.norm(a - b) / (np.linalg.norm(a) + 1e-30)
        # f32 CG at rtol 1e-6 keeps trajectories within ~1e-3 relative
        # over the first VAMP iterations on a well-conditioned panel.
        assert rel < 5e-3, f"f32 diverged at it={it}: rel={rel}"


def test_nonfinite_abort_guard():
    """Poisoned input (NaN in r) must stop the run at iteration 0 instead
    of writing NaN outputs to completion like the reference would."""
    d = simulate_single(800, 64, h2=0.8, lam=0.1, rng=np.random.default_rng(1))
    r = d.r.copy()
    r[3] = np.nan
    prior = PriorState.create(0.1, [1.0], [0.01 * 800])
    inputs = VampInputs(op=DenseLD(mats=jnp.asarray(d.R)[None], s=0.1),
                        r=jnp.asarray(r)[None], a=jnp.asarray([1.0]),
                        N=jnp.asarray([800.0]))
    eng = VampEngine(inputs, VampConfig(dtype="float64"), prior)
    hist = eng.run(5)
    assert hist.get("aborted_at") == 0
    # the poisoned iteration's outputs are NOT recorded/written
    assert len(hist["xhat1"]) == 0


def _first_nonfinite(band, r, x0, K, guards, iters=16):
    """Run K replicated cohorts (statistically degenerate on purpose) and
    return the first iteration with a non-finite state leaf (or None)."""
    from sgvamp.core import vamp as V
    import jax

    M = r.shape[0]
    cm = max(int(M * 0.01), 1)
    op = BandedLD.from_band(band, block_size=128, dtype="float32", K=K)
    Mp = op.M
    mask = np.zeros(Mp, np.float32)
    mask[:M] = 1
    rp = np.zeros((K, Mp), np.float32)
    rp[:, :M] = r
    cfg = VampConfig(prior_update="em", dtype="float32", cg_maxit=50,
                     cg_force_maxiter=True, em_prior_maxit=5, rho=0.5,
                     lmmse_damp=True, clip_alpha1=guards, clip_alpha2=guards,
                     gam_clamp=1e8 if guards else 0.0)
    prior = PriorState.create(0.01, [1.0], [0.7 / cm * 300000])
    inputs = VampInputs(op=op, r=jnp.asarray(rp),
                        a=jnp.full((K,), 1.0 / K, jnp.float32),
                        N=jnp.full((K,), 300000.0, jnp.float32),
                        mask=jnp.asarray(mask))
    state = V.init_state(inputs, cfg, prior, gamw=5.0, gam1=1e-6)
    step = jax.jit(lambda s, i: V.vamp_step(s, i, cfg, None))
    first_bad, alpha2_oob_while_finite = None, False
    for it in range(1, iters + 1):
        state, aux = step(state, inputs)
        a2 = np.asarray(aux.alpha2)
        finite = (np.isfinite(np.asarray(state.gam1)).all()
                  and np.isfinite(np.asarray(state.r1)).all()
                  and np.isfinite(np.asarray(state.xhat1)).all())
        if first_bad is None and finite and guards and (
                (a2 < 1e-5).any() or (a2 > 1 - 1e-5).any()):
            alpha2_oob_while_finite = True
        if first_bad is None and not finite:
            first_bad = it
    assert not alpha2_oob_while_finite, "clip_alpha2 must bound alpha2"
    return first_bad


def test_guards_extend_finite_horizon():
    """clip_alpha1 + clip_alpha2 + gam_clamp (all opt-in; the reference has
    none of them - its intended alpha1 clip is a discarded no-op,
    sgvamp.py:293) must extend how long a degenerate replicated-cohort
    run stays finite. Replicating one cohort K times makes the meta
    denoiser overconfident by K, collapses the EM prior (lam -> 1), and
    overflows the unguarded f32 recursion; the guards cannot make
    post-convergence iterates meaningful (gVAMP is early-stopped) but
    must keep alpha2 in its provably-feasible (0,1) and buy iterations."""
    rng = np.random.default_rng(0)
    band, r, x0 = simulate_ld_band(300000, 2048, bandwidth=64, rng=rng,
                                   dtype=np.float32, h2=0.7, lam=0.01)
    bad_plain = _first_nonfinite(band, r, x0, K=8, guards=False)
    bad_guard = _first_nonfinite(band, r, x0, K=8, guards=True)
    assert bad_plain is not None, "degenerate config should overflow unguarded"
    assert bad_guard is None or bad_guard > bad_plain


def test_simulate_independent_cohorts():
    """n_r=K draws K INDEPENDENT noise vectors over a shared panel+signal:
    rows must differ (independent noise) yet correlate strongly (shared
    R @ x0 term) - the meta-analysis the K>1 bench models. n_r=1 keeps the
    legacy 1-D return shape and RNG stream."""
    rng = np.random.default_rng(5)
    band, rs, x0 = simulate_ld_band(50000, 1024, bandwidth=32, rng=rng,
                                    dtype=np.float64, h2=0.7, lam=0.05,
                                    n_r=4)
    assert rs.shape == (4, 1024)
    rng2 = np.random.default_rng(5)
    band2, r1, x02 = simulate_ld_band(50000, 1024, bandwidth=32, rng=rng2,
                                      dtype=np.float64, h2=0.7, lam=0.05)
    assert r1.shape == (1024,)
    np.testing.assert_array_equal(band, band2)
    np.testing.assert_array_equal(x0, x02)
    # same RNG stream: the first of the 4 draws IS the single draw
    np.testing.assert_allclose(rs[0], r1)
    C = np.corrcoef(rs)
    off = C[~np.eye(4, dtype=bool)]
    assert (off < 0.9999).all()           # genuinely different noise
    assert (off > 0.5).all()              # shared signal dominates at h2=0.7
