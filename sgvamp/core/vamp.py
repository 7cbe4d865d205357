"""The VAMP iteration as a pure, jit-compiled state -> state function.

This is the accelerator-native inversion of the reference's host-driven loop
(reference src/sgvamp.py:196-388): instead of K MPI ranks each looping over
markers in Python and exchanging (gam1, r1) via pickled broadcasts
(src/sgvamp.py:226-233), the whole multi-cohort state lives in (K, ...)
arrays inside one compiled program. Cross-cohort combination is a weighted
reduction (a psum over the mesh's cohort axis when sharded); the two CG
solves are batched over cohorts and their matvec block-shards over the
mesh's shard axis. Hosts only do I/O between steps.
"""

from __future__ import annotations

import dataclasses
import logging
import time
from typing import Any, Dict, NamedTuple, Optional, Tuple

import jax
import jax.numpy as jnp
import numpy as np
from jax import Array

from sgvamp.config import VampConfig
from sgvamp.core.cg import cg_batched
from sgvamp.core.denoiser import combine_cohorts, posterior_mean_and_slope
from sgvamp.core.prior import PriorState, em_loop, mle_update

logger = logging.getLogger("sgvamp")


@jax.tree_util.register_dataclass
@dataclasses.dataclass(frozen=True)
class VampInputs:
    """Per-run constant inputs.

    op: LD operator with batched matvec (K, M) -> (K, M) (already carries
        the (1-s)R + sI regularization, reference src/main.py:265).
    r:  (K, M) marginal-association vectors X^T y per cohort.
    a:  (K,) cohort weights N_k / Nt (reference src/main.py:287).
    N:  (K,) per-cohort sample counts (reference src/main.py:85).
    mask: optional (M,) 0/1 marker-validity mask. When the operator pads M
        up to a block multiple, padded markers carry mask 0 and are
        excluded from every marker-mean/trace (alpha1, alpha2, EM/MLE
        sums, Hutchinson probes), making padded runs exactly equal to
        unpadded ones.
    """

    op: Any
    r: Array
    a: Array
    N: Array
    mask: Optional[Array] = None
    # One-time block-Jacobi factorization cache (core/precond.py
    # block_jacobi_eig): eigenvectors (K, M/P, P, P) and eigenvalues
    # (K, M/P, P) of the diagonal sub-blocks of Rused. When present, each
    # iteration's preconditioner rebuild is two batched matmuls instead of
    # a batched LU (2.7 s -> 47 ms at the K=8 x M=1M ceiling).
    precond_q: Optional[Array] = None
    precond_lam: Optional[Array] = None

    @property
    def M_active(self) -> Array:
        if self.mask is None:
            return self.r.shape[1]
        return jnp.sum(self.mask)


@jax.tree_util.register_dataclass
@dataclasses.dataclass(frozen=True)
class VampState:
    """Complete VAMP iteration state (reference locals, src/sgvamp.py:198-217)."""

    it: Array          # scalar int32
    xhat1: Array       # (M,)  denoised estimate (shared across cohorts)
    alpha1: Array      # (K,)  denoiser Onsager terms
    r1: Array          # (K, M) extrinsic means into the denoiser
    gam1: Array        # (K,)  extrinsic precisions into the denoiser
    xhat2: Array       # (K, M) LMMSE estimates
    r2: Array          # (K, M) extrinsic means into LMMSE
    alpha2: Array      # (K,)  LMMSE Onsager terms
    gam2: Array        # (K,)
    gamw: Array        # (K,)  noise precision (floored, used next iteration)
    sigma2_u: Array    # (K, M) warm start for the Hutchinson CG solve
    prior: PriorState
    key: Array         # PRNG key for Rademacher probes


class StepAux(NamedTuple):
    """Per-iteration observables for writers/logging (host side)."""

    xhat1: Array        # (M,) damped denoised estimate of this iteration
    r1_in: Array        # (K, M) the r1 used this iteration (pre-recursion)
    gamw_raw: Array     # (K,) gamw before the 1.0 floor (reference logs this, :371-373)
    gamw: Array         # (K,) floored gamw written to CSV (:374,377)
    gam1: Array         # (K,) updated gam1 written to CSV
    gam2: Array         # (K,)
    alpha1: Array       # (K,)
    alpha2: Array       # (K,)
    lam: Array          # scalar, post-update
    cg1_iters: Array    # (K,) int32
    cg1_converged: Array
    cg2_iters: Array
    cg2_converged: Array
    em_sweeps: Array    # scalar int32 (0 when EM not run)
    em_rel_err: Array   # scalar
    mle_ok: Array       # bool: last MLE update accepted (True when unused)


def alignment_l2(xhat1: np.ndarray, x0v: np.ndarray) -> Tuple[float, float]:
    """Cosine alignment and relative L2 vs the true signal (reference
    src/sgvamp.py:379-387). Guarded: an all-zero xhat1 (e.g. the denoiser
    returns zeros at iteration 0) reports alignment 0.0 instead of a NaN
    metrics row."""
    nx, n0 = np.linalg.norm(xhat1), np.linalg.norm(x0v)
    if n0 == 0.0:
        # degenerate truth: alignment undefined -> 0; relative L2 is 0
        # only if the estimate is also zero, else unbounded
        return 0.0, 0.0 if nx == 0.0 else float("inf")
    if nx == 0.0:
        return 0.0, 1.0
    return (float(np.inner(xhat1, x0v) / (nx * n0)),
            float(np.linalg.norm(xhat1 - x0v) / n0))


class StopState(NamedTuple):
    """On-device mirror of StopMonitor's carry, for fused (lax.scan) runs.

    Same criteria and update order as StopMonitor.update (which defines
    the semantics; see its docstring): divergence checked before
    convergence, best-iterate snapshot at the running gam1 peak with
    ties updating. reason codes: 0 = none, 1 = diverging, 2 = converged.
    """

    done: Array        # bool — a criterion has fired; later scan steps no-op
    reason: Array      # int32 code (0/1/2)
    stopped_at: Array  # int32 iteration index, -1 when never stopped
    prev_xhat1: Array  # (M,) previous iteration's xhat1
    has_prev: Array    # bool — prev_xhat1 is valid
    gam1_peak: Array   # scalar running peak of min_k gam1
    best_it: Array     # int32, -1 before any finite iteration
    best_xhat1: Array  # (M,) snapshot at the gam1 peak
    n_ran: Array       # int32 — steps actually executed (not skipped)

    @staticmethod
    def create(M: int, dtype) -> "StopState":
        return StopState(
            done=jnp.zeros((), bool),
            reason=jnp.zeros((), jnp.int32),
            stopped_at=jnp.full((), -1, jnp.int32),
            prev_xhat1=jnp.zeros((M,), dtype),
            has_prev=jnp.zeros((), bool),
            gam1_peak=jnp.full((), -jnp.inf, dtype),
            best_it=jnp.full((), -1, jnp.int32),
            best_xhat1=jnp.zeros((M,), dtype),
            n_ran=jnp.zeros((), jnp.int32),
        )

    REASONS = {0: None, 1: "diverging", 2: "converged"}


def stop_state_update(mon: StopState, it: Array, xhat1: Array, gam1: Array,
                      tol: float, gam1_drop: float) -> StopState:
    """One StopMonitor.update step on device (same order of criteria)."""
    g = jnp.min(gam1)
    finite = jnp.isfinite(g) & jnp.all(jnp.isfinite(xhat1))
    take_best = finite & (g >= mon.gam1_peak)
    gam1_peak = jnp.where(take_best, g, mon.gam1_peak)
    best_it = jnp.where(take_best, it, mon.best_it)
    best_xhat1 = jnp.where(take_best, xhat1, mon.best_xhat1)

    diverging = jnp.where(
        ~finite,
        gam1_drop > 0,
        (gam1_drop > 0) & (best_it >= 0) & (g < gam1_peak / gam1_drop),
    )
    denom = jnp.linalg.norm(mon.prev_xhat1) + 1e-300
    rel = jnp.linalg.norm(xhat1 - mon.prev_xhat1) / denom
    # convergence is only ever evaluated on finite iterations (StopMonitor
    # takes its `not finite` branch first and never reaches the tol check)
    converged = (~diverging) & finite & (tol > 0) & mon.has_prev & (rel < tol)
    reason = jnp.where(diverging, 1, jnp.where(converged, 2, 0)).astype(jnp.int32)
    fired = reason > 0
    return StopState(
        done=fired,
        reason=jnp.where(fired, reason, mon.reason),
        stopped_at=jnp.where(fired, it, mon.stopped_at).astype(jnp.int32),
        prev_xhat1=xhat1,
        has_prev=jnp.ones((), bool),
        gam1_peak=gam1_peak,
        best_it=best_it.astype(jnp.int32),
        best_xhat1=best_xhat1,
        n_ran=mon.n_ran + 1,
    )


class StopMonitor:
    """Truth-free convergence/divergence detection for the early-stopped
    gVAMP iteration (host-side; a capability the reference lacks — it runs
    a fixed iteration count, reference src/main.py:37, and the user picks
    the best iterate post-hoc from the metrics CSV, src/main.py:326-338).

    gVAMP iterated past the data's information content destabilizes: the
    precision recursion grows geometrically, then collapses, and the
    estimate decays (see VampConfig.gam_clamp notes; the reference's own
    f64 math overflows the same way). Two criteria, both computable
    without the true signal:

      * ``converged`` — the relative change of xhat1 between iterations
        falls below ``tol``: the iteration has settled.
      * ``diverging`` — ``min_k gam1_k`` falls below its running peak by
        more than a factor of ``gam1_drop`` (or goes non-finite). gam1 is
        the algorithm's own estimate of how informative the extrinsic
        means are; measured on both the benign and the degenerate bench
        panels it peaks within an iteration of the alignment peak and
        then collapses by orders of magnitude as the alignment decays, so
        its collapse is the truth-free proxy for "past the operating
        point".

    The monitor always snapshots xhat1 at the running gam1 peak
    (``best_xhat1`` / ``best_it``) so a stopped run can report the
    selected iterate — the automated version of the reference's post-hoc
    CSV selection. Criteria default off (0.0) for reference parity.
    """

    def __init__(self, tol: float = 0.0, gam1_drop: float = 0.0) -> None:
        self.tol = float(tol)
        self.gam1_drop = float(gam1_drop)
        self.prev_xhat1: Optional[np.ndarray] = None
        self.best_xhat1: Optional[np.ndarray] = None
        self.best_it: int = -1
        self.gam1_peak: float = -np.inf
        self.stopped_at: int = -1
        self.reason: Optional[str] = None

    def update(self, it: int, xhat1: np.ndarray, gam1: np.ndarray) -> Optional[str]:
        """Feed one iteration's (xhat1, gam1); returns a stop reason or None."""
        xhat1 = np.asarray(xhat1)
        g = float(np.min(np.asarray(gam1, np.float64)))
        finite = np.isfinite(g) and bool(np.all(np.isfinite(xhat1)))
        if finite and g >= self.gam1_peak:
            self.gam1_peak = g
            self.best_xhat1 = xhat1.copy()
            self.best_it = it
        reason = None
        if not finite:
            if self.gam1_drop > 0:
                reason = "diverging"
        elif (self.gam1_drop > 0 and self.best_it >= 0
                and g < self.gam1_peak / self.gam1_drop):
            reason = "diverging"
        elif self.tol > 0 and self.prev_xhat1 is not None:
            denom = float(np.linalg.norm(self.prev_xhat1))
            rel = float(np.linalg.norm(xhat1 - self.prev_xhat1)) / (denom + 1e-300)
            if rel < self.tol:
                reason = "converged"
        self.prev_xhat1 = xhat1
        if reason is not None and self.reason is None:
            self.stopped_at, self.reason = it, reason
        return reason


def init_state(inputs: VampInputs, cfg: VampConfig, prior: PriorState,
               gamw: float, gam1: float, seed: int = 0) -> VampState:
    """Initial state (reference src/sgvamp.py:198-217)."""
    dtype = cfg.jnp_dtype
    K, M = inputs.r.shape
    prior = jax.tree_util.tree_map(
        lambda x: x.astype(dtype)
        if hasattr(x, "dtype") and jnp.issubdtype(x.dtype, jnp.floating)
        else x,
        prior,
    )
    z = jnp.zeros((K, M), dtype)
    return VampState(
        it=jnp.zeros((), jnp.int32),
        xhat1=jnp.zeros((M,), dtype),
        alpha1=jnp.zeros((K,), dtype),
        r1=inputs.r.astype(dtype),
        gam1=jnp.full((K,), gam1, dtype),
        xhat2=z,
        r2=z,
        alpha2=jnp.zeros((K,), dtype),
        gam2=jnp.zeros((K,), dtype),
        gamw=jnp.full((K,), gamw, dtype),
        sigma2_u=z,
        prior=prior,
        key=jax.random.PRNGKey(seed),
    )


def vamp_step(
    state: VampState,
    inputs: VampInputs,
    cfg: VampConfig,
    u: Optional[Array] = None,
) -> Tuple[VampState, StepAux]:
    """One full VAMP iteration (reference src/sgvamp.py:222-387).

    `u` optionally injects the (K, M) Rademacher probe for the Hutchinson
    estimator (test hook for trajectory-exact comparison against the
    reference, which consumes numpy's global RNG at src/sgvamp.py:326);
    when None, probes are drawn from the state's PRNG key.
    """
    K, M = state.r1.shape
    r1s, gam1s = state.r1, state.gam1
    prior = state.prior
    it = state.it
    mask = inputs.mask
    M_active = inputs.M_active

    # ---- Prior update (reference :242-259) ----
    do_update = it >= cfg.update_prior_from
    em_sweeps = jnp.zeros((), jnp.int32)
    em_rel_err = jnp.zeros((), cfg.jnp_dtype)
    if cfg.prior_update == "em":
        def run_em(p: PriorState):
            lam, om, sweeps, err = em_loop(
                r1s, gam1s, inputs.a, p.lam, p.omegas, p.sigmas,
                cfg.em_prior_maxit, cfg.em_rel_tol, mask=mask,
            )
            return dataclasses.replace(p, lam=lam, omegas=om), sweeps, err

        def skip_em(p: PriorState):
            return p, jnp.zeros((), jnp.int32), jnp.zeros((), cfg.jnp_dtype)

        prior, em_sweeps, em_rel_err = jax.lax.cond(do_update, run_em, skip_em, prior)
    elif cfg.prior_update == "mle":
        prior = jax.lax.cond(
            do_update,
            lambda p: mle_update(r1s, gam1s, inputs.a, p, cfg.mle_maxit,
                                 cfg.mle_tol, mask=mask),
            lambda p: p,
            prior,
        )

    # ---- Denoising (reference :266-296) ----
    b, A, c = combine_cohorts(r1s, gam1s, inputs.a)
    xhat1_new, dxdb = posterior_mean_and_slope(b, A, prior.lam, prior.omegas, prior.sigmas)
    if cfg.rho_final is not None and cfg.rho_anneal_iters > 0:
        frac = jnp.minimum(it.astype(cfg.jnp_dtype) / cfg.rho_anneal_iters, 1.0)
        rho = cfg.rho + (cfg.rho_final - cfg.rho) * frac
    else:
        rho = cfg.rho
    xhat1 = jnp.where(it > 0, rho * xhat1_new + (1 - rho) * state.xhat1, xhat1_new)

    # alpha1_k = mean_j d xhat_j / d r1_kj = c_k * mean_j d xhat_j / d b_j
    if mask is None:
        alpha1 = c * jnp.mean(dxdb)
    else:
        alpha1 = c * (jnp.sum(dxdb * mask) / M_active)
    alpha1 = jnp.where(it > 0, rho * alpha1 + (1 - rho) * state.alpha1, alpha1)
    if cfg.clip_alpha1:
        # The reference *intended* this clip but discards np.clip's result
        # (src/sgvamp.py:293, quirks ledger #1); off by default for parity.
        alpha1 = jnp.clip(alpha1, 1e-5, 1 - 1e-5)

    # ---- LMMSE (reference :298-323) ----
    gam2 = gam1s * (1 - alpha1) / alpha1
    if cfg.gam_clamp > 0:
        # standard VAMP gamma_min/gamma_max guard (VampConfig.gam_clamp)
        gam2 = jnp.clip(gam2, 1.0 / cfg.gam_clamp, cfg.gam_clamp)
    r2 = (xhat1[None, :] - alpha1[:, None] * r1s) / (1 - alpha1)[:, None]
    gamw = state.gamw
    mu2 = gamw[:, None] * inputs.r + gam2[:, None] * r2

    # Draw the Hutchinson probe up front so its CG solve can FUSE with the
    # LMMSE solve: both systems share A_k = gamw_k R_k + gam2_k I, so one
    # multi-RHS batched CG of 2K lanes reads each R block once per
    # iteration - half the HBM traffic of the reference's two sequential
    # scipy solves (src/sgvamp.py:316,332).
    key, sub = jax.random.split(state.key)
    if u is None:
        u = jax.random.rademacher(sub, (K, M), cfg.jnp_dtype)
    else:
        u = u.astype(cfg.jnp_dtype)
    if mask is not None:
        u = u * mask[None, :]

    gamw2 = jnp.concatenate([gamw, gamw])
    gam22 = jnp.concatenate([gam2, gam2])

    def amatvec2(x: Array) -> Array:
        # A @ x = gamw * (R @ x) + gam2 * x, never materializing A
        # (unlike reference src/sgvamp.py:312).
        return gamw2[:, None] * inputs.op.matvec(x) + gam22[:, None] * x

    precond = None
    if cfg.cg_precond_block:
        # Block-Jacobi M^{-1} rebuilt from this iteration's (gamw, gam2):
        # one batched rebuild amortized over all CG iterations. Both lane
        # groups (LMMSE rhs and Hutchinson probe) share per-cohort systems,
        # so one (K, ...) inverse serves the 2K-lane fused solve. With the
        # engine's cached eigendecomposition the rebuild is two batched
        # matmuls; without it (library callers using vamp_step directly)
        # fall back to the chunked batched inverse.
        from sgvamp.core.precond import (apply_block_jacobi,
                                         block_jacobi_from_eig,
                                         block_jacobi_inverse)
        if inputs.precond_q is not None:
            pinv = block_jacobi_from_eig(
                inputs.precond_q, inputs.precond_lam, gamw, gam2,
                dtype=jnp.dtype(cfg.cg_precond_dtype))
        else:
            pinv = block_jacobi_inverse(inputs.op, gamw, gam2,
                                        cfg.cg_precond_block,
                                        dtype=jnp.dtype(cfg.cg_precond_dtype))
        precond = lambda v: apply_block_jacobi(pinv, v)

    cg = cg_batched(
        amatvec2,
        jnp.concatenate([mu2, u], axis=0),
        jnp.concatenate([state.xhat2, state.sigma2_u], axis=0),
        cfg.cg_maxit, cfg.cg_rtol, cfg.cg_atol, cfg.cg_force_maxiter,
        precond=precond,
    )
    xhat2, sigma2_u = cg.x[:K], cg.x[K:]
    if cfg.lmmse_damp:
        xhat2 = rho * xhat2 + (1 - rho) * state.xhat2

    # ---- Hutchinson / Onsager-2 (reference :325-346) ----
    tr_sigma2 = jnp.einsum("km,km->k", u, sigma2_u)
    alpha2 = gam2 * tr_sigma2 / M_active
    if cfg.lmmse_damp:
        alpha2 = rho * alpha2 + (1 - rho) * state.alpha2
    if cfg.clip_alpha2:
        # Project the Hutchinson estimate back into alpha2's provably-
        # feasible region (0, 1) - see VampConfig.clip_alpha2. Keeps
        # gam1_new positive when gam2 is so large that (1 - alpha2) sinks
        # below the estimator noise floor (the failure mode that NaNs both
        # this engine and the reference on near-noiseless panels).
        alpha2 = jnp.clip(alpha2, 1e-5, 1 - 1e-5)

    # ---- Precision recursions (reference :347-348) ----
    gam1_new = gam2 * (1 - alpha2) / alpha2
    if cfg.gam_clamp > 0:
        gam1_new = jnp.clip(gam1_new, 1.0 / cfg.gam_clamp, cfg.gam_clamp)
    r1_new = (xhat2 - alpha2[:, None] * r2) / (1 - alpha2)[:, None]

    # ---- Noise precision learning (reference :350-374) ----
    if cfg.learn_gamw:
        # One fused multi-RHS pass computes both R @ xhat2 (for z,
        # reference :352) and R @ Sigma2_u (for the trace term, :359).
        Rboth = inputs.op.matvec(jnp.concatenate([xhat2, sigma2_u], axis=0))
        z = (
            inputs.N
            - 2.0 * jnp.einsum("km,km->k", xhat2, inputs.r)
            + jnp.einsum("km,km->k", xhat2, Rboth[:K])
        )
        z = jnp.maximum(z, 0.0)  # reference clips z at 0 (:353-354)
        tr_r_sigma2 = jnp.einsum("km,km->k", u, Rboth[K:])
        gamw_raw = 1.0 / (z / inputs.N + tr_r_sigma2 / inputs.N)
    else:
        gamw_raw = gamw
    gamw_new = jnp.maximum(gamw_raw, 1.0)  # floor (reference :374)

    new_state = VampState(
        it=it + 1,
        xhat1=xhat1,
        alpha1=alpha1,
        r1=r1_new,
        gam1=gam1_new,
        xhat2=xhat2,
        r2=r2,
        alpha2=alpha2,
        gam2=gam2,
        gamw=gamw_new,
        sigma2_u=sigma2_u,
        prior=prior,
        key=key,
    )
    aux = StepAux(
        xhat1=xhat1,
        r1_in=r1s,
        gamw_raw=gamw_raw,
        gamw=gamw_new,
        gam1=gam1_new,
        gam2=gam2,
        alpha1=alpha1,
        alpha2=alpha2,
        lam=prior.lam,
        cg1_iters=cg.iters[:K],
        cg1_converged=cg.converged[:K],
        cg2_iters=cg.iters[K:],
        cg2_converged=cg.converged[K:],
        em_sweeps=em_sweeps,
        em_rel_err=em_rel_err,
        mle_ok=prior.mle_last_ok,
    )
    return new_state, aux


class VampEngine:
    """Host-side driver around the jitted step.

    Two execution modes:
      * run():      host loop, one device dispatch per iteration, with
                    reference-format output writing between steps
                    (the analogue of reference VAMP.infer + its I/O).
      * run_scan(): the entire run fused into one lax.scan program -- no
                    host round-trips; used for benchmarking and when no
                    per-iteration I/O is needed.
    """

    def __init__(
        self,
        inputs: VampInputs,
        cfg: VampConfig,
        prior: PriorState,
        gamw: float = 5.0,
        gam1: float = 1e-6,
        mesh: Optional[jax.sharding.Mesh] = None,
    ) -> None:
        self.inputs = inputs
        self.cfg = cfg
        self.prior = prior
        self.gamw0 = gamw
        self.gam10 = gam1
        self.mesh = mesh
        if (cfg.cg_precond_block and cfg.cg_precond_eig
                and inputs.precond_q is None):
            # One-time factorization of the diagonal sub-blocks; every
            # step then rebuilds the shifted inverse with two batched
            # matmuls (see core/precond.py block_jacobi_eig).
            from sgvamp.core.precond import block_jacobi_eig
            Q, lam = jax.jit(
                block_jacobi_eig, static_argnums=(1, 2, 3))(
                    inputs.op, cfg.cg_precond_block, 2048,
                    cfg.cg_precond_dtype)
            self.inputs = inputs = dataclasses.replace(
                inputs, precond_q=Q, precond_lam=lam)
        if mesh is not None:
            from sgvamp.parallel.sharding import shard_inputs
            self.inputs = shard_inputs(self.inputs, mesh)
        # inputs are jit *arguments*, not closure captures: capturing them
        # would bake the LD blocks into the program as multi-GB constants
        # (slow lowering + doubled device memory).
        self._step = jax.jit(lambda s, i, u: vamp_step(s, i, cfg, u))
        self._step_rand = jax.jit(lambda s, i: vamp_step(s, i, cfg, None))

    def init_state(self, seed: int = 0) -> VampState:
        state = init_state(self.inputs, self.cfg, self.prior,
                           self.gamw0, self.gam10, seed)
        if self.mesh is not None:
            from sgvamp.parallel.sharding import shard_state
            state = shard_state(state, self.mesh)
        return state

    def run(
        self,
        iterations: int,
        state: Optional[VampState] = None,
        fixed_u: Optional[np.ndarray] = None,
        writer: Optional[Any] = None,
        x0: Optional[np.ndarray] = None,
        Nt: Optional[float] = None,
        seed: int = 0,
        callback=None,
        M_out: Optional[int] = None,
        it0: int = 0,
        abort_on_nonfinite: bool = True,
        fetch_aux_full: Optional[bool] = None,
        stop_tol: float = 0.0,
        stop_gam1_drop: float = 0.0,
    ) -> Dict[str, Any]:
        """Run `iterations` VAMP steps with per-iteration host I/O.

        fixed_u: optional (iterations, K, M) Rademacher probes (test hook).
        writer: an io.writers.OutputWriter (or None).
        stop_tol / stop_gam1_drop: StopMonitor thresholds (0 = off, the
            reference-parity default of a fixed iteration count). When a
            criterion fires the loop stops early; history records
            stopped_at/stop_reason, and best_it/best_xhat1 always carry
            the monitor's selected iterate (the xhat1 at the running gam1
            peak — the automated version of the reference's post-hoc
            metrics-CSV selection).
        fetch_aux_full: under jax.distributed, whether to all-gather the
            (K, M) r1_in aux leaf to every host each iteration (only a
            writer reads it). Default (None): the processes agree
            collectively at run start — if ANY process holds a writer,
            all fetch; otherwise none do — so the CLI's
            writer-on-process-0 layout needs no plumbing. Explicit values
            must match on every process; a conflict raises here instead
            of deadlocking in iteration 0.
        x0: true signal for metrics (already scaled, reference src/main.py:276).
        Nt: total sample count, for the xhat/r1 output scaling by 1/sqrt(Nt)
            (reference src/sgvamp.py:281,283).
        M_out: trim vectors to this length in outputs (when the operator
            padded M up to a block multiple).
        it0: iteration offset for file naming/CSV rows when resuming.
        abort_on_nonfinite: stop the run (with everything produced so far
            in the history, and history["aborted_at"] set) if the state
            goes NaN/inf - a failure detector the reference lacks (it
            would silently write NaN outputs to completion).
        """
        if state is None:
            state = self.init_state(seed)
        history: Dict[str, Any] = {
            "xhat1": [], "alignment": [], "l2": [], "params": [],
            "cg1_iters": [], "cg2_iters": [],
        }
        x0v = None if x0 is None else np.asarray(x0).squeeze()
        monitor = StopMonitor(tol=stop_tol, gam1_drop=stop_gam1_drop)
        bpp = getattr(self.inputs.op, "bytes_per_pass", lambda: 0)()
        multiproc = jax.process_count() > 1
        if multiproc:
            # The r1_in fetch below is a COLLECTIVE: every process must
            # agree on whether it happens or the program hangs. Agree once
            # up front via a tiny allgather instead of trusting callers to
            # plumb the same value everywhere: by default any process
            # holding a writer opts the whole job in (the CLI's layout -
            # writer on process 0 only - then Just Works); explicit values
            # must match on every process and a conflict fails loudly here
            # rather than deadlocking in iteration 0.
            from jax.experimental import multihost_utils
            code = -1 if fetch_aux_full is None else int(bool(fetch_aux_full))
            flags = np.asarray(multihost_utils.process_allgather(
                np.asarray([int(writer is not None), code], np.int32)))
            any_writer = bool(flags[:, 0].any())
            explicit = flags[:, 1]
            vals = set(int(v) for v in explicit if v >= 0)
            if vals:
                if len(vals) > 1:
                    raise ValueError(
                        f"fetch_aux_full disagrees across processes "
                        f"(per-process values {explicit.tolist()}; -1 = "
                        f"unset): every process must pass the same value")
                fetch_full = bool(vals.pop())
            else:
                fetch_full = any_writer
            if any_writer and not fetch_full:
                raise ValueError("fetch_aux_full=False is incompatible with "
                                 "a writer (it needs the r1_in aux leaf)")
        else:
            fetch_full = (writer is not None if fetch_aux_full is None
                          else bool(fetch_aux_full))
            if writer is not None and not fetch_full:
                raise ValueError("fetch_aux_full=False is incompatible with "
                                 "a writer (it needs the r1_in aux leaf)")
        for rel_it in range(iterations):
            it = it0 + rel_it
            logger.info(f"\n -----ITERATION {it} -----")
            t_step = time.perf_counter()
            if fixed_u is not None:
                state, aux = self._step(state, self.inputs, jnp.asarray(fixed_u[rel_it]))
            else:
                state, aux = self._step_rand(state, self.inputs)
            if multiproc:
                # Cross-process-sharded aux arrays are not host-addressable;
                # collectively all-gather them so the (host-side) I/O below
                # works unchanged under jax.distributed. The (K, M) r1_in
                # leaf is the only one nobody reads without a writer — at
                # M=1M, K=8 skipping it saves ~64MB of cross-host traffic per
                # iteration on writer-less runs.
                from sgvamp.parallel.multihost import fetch_global
                aux = StepAux(**{
                    name: (getattr(aux, name)
                           if name == "r1_in" and not fetch_full
                           else fetch_global(getattr(aux, name)))
                    for name in StepAux._fields})
            xhat1 = np.asarray(aux.xhat1)[:M_out]
            dt_step = time.perf_counter() - t_step
            # Achieved-bandwidth counter (SURVEY section 5): LD passes =
            # the fused CG's iterations + the initial residual + the fused
            # gamw pass; each reads the LD blocks once for all lanes.
            passes = int(max(np.max(aux.cg1_iters), np.max(aux.cg2_iters))) + 2
            if bpp and dt_step > 0:
                logger.debug(
                    f"[roofline] iteration {it}: {dt_step:.4f}s, "
                    f"{passes} LD passes, achieved "
                    f"{bpp * passes / dt_step / 1e9:.1f} GB/s (incl. dispatch)"
                )
            r1_in = (np.asarray(aux.r1_in)[:, :M_out]
                     if (fetch_full or not multiproc) else None)
            self._log_iteration(it, aux)
            stop_reason = monitor.update(it, xhat1, np.asarray(aux.gam1))
            if abort_on_nonfinite and not (
                np.all(np.isfinite(xhat1)) and np.all(np.isfinite(np.asarray(aux.gam1)))
            ):
                if stop_reason is not None:
                    # divergence detection turned the non-finite abort into
                    # a clean stop: the monitor's best-so-far snapshot is
                    # the deliverable.
                    logger.info(
                        f"STOP at iteration {it} ({stop_reason}); best "
                        f"iterate: iteration {monitor.best_it}"
                    )
                    history["stopped_at"] = it
                    history["stop_reason"] = stop_reason
                else:
                    logger.info(
                        f"ERROR: non-finite state at iteration {it}; aborting run "
                        f"(outputs up to iteration {it - 1} are on disk)"
                    )
                    history["aborted_at"] = it
                break
            history["xhat1"].append(xhat1)
            history["cg1_iters"].append(np.asarray(aux.cg1_iters))
            history["cg2_iters"].append(np.asarray(aux.cg2_iters))
            lam = float(aux.lam)
            K = np.asarray(aux.gamw).shape[0]
            rows = []
            for k in range(K):
                rows.append([
                    it, float(aux.gamw[k]), float(aux.gam1[k]), float(aux.gam2[k]),
                    float(aux.alpha1[k]), float(aux.alpha2[k]), lam,
                ])
            history["params"].append(rows)
            if writer is not None:
                scale = 1.0 / np.sqrt(Nt) if Nt else 1.0
                writer.write_xhat(it, xhat1 * scale)
                for k in range(K):
                    writer.write_r1(it, r1_in[k] * scale, k + 1)
                    writer.write_params(rows[k], k)
            if x0v is not None:
                alignment, l2 = alignment_l2(xhat1, x0v)
                history["alignment"].append(alignment)
                history["l2"].append(l2)
                if writer is not None:
                    writer.write_metrics([it, alignment, l2])
            if callback is not None:
                callback(it, state, aux)
            if stop_reason is not None:
                logger.info(
                    f"STOP at iteration {it} ({stop_reason}); best iterate: "
                    f"iteration {monitor.best_it}"
                )
                history["stopped_at"] = it
                history["stop_reason"] = stop_reason
                break
        history["state"] = state
        history["best_it"] = monitor.best_it
        history["best_xhat1"] = monitor.best_xhat1
        return history

    def _log_iteration(self, it: int, aux: StepAux) -> None:
        """Per-iteration diagnostics, mirroring the reference's logging
        (reference src/sgvamp.py:296,308,318-319,335-336,343,371 - but
        emitted once by the single driver instead of per-rank)."""
        cg1_i = np.asarray(aux.cg1_iters)
        cg1_c = np.asarray(aux.cg1_converged)
        cg2_i = np.asarray(aux.cg2_iters)
        cg2_c = np.asarray(aux.cg2_converged)
        if self.cfg.cg_force_maxiter:  # fixed budgets never "converge"
            cg1_c = cg2_c = np.ones_like(cg1_c)
        for k in range(cg1_i.shape[0]):
            if not cg1_c[k]:
                logger.info(
                    f"Cohort {k} WARNING: CG 1 convergence after {int(cg1_i[k])} iterations not achieved!"
                )
            if not cg2_c[k]:
                logger.info(
                    f"Cohort {k} WARNING: CG 2 convergence after {int(cg2_i[k])} iterations not achieved!"
                )
        logger.debug(f"alpha1 = {np.asarray(aux.alpha1)}")
        logger.debug(f"gam2 = {np.asarray(aux.gam2)}")
        logger.debug(f"alpha2 = {np.asarray(aux.alpha2)}")
        logger.debug(f"gam1 = {np.asarray(aux.gam1)}")
        logger.debug(f"gamw = {np.asarray(aux.gamw_raw)}")
        logger.debug(f"lam = {float(aux.lam):0.9f}")
        if self.cfg.prior_update == "em" and int(aux.em_sweeps) > 0:
            logger.info(
                f"... prior-learning EM algorithm performed {int(aux.em_sweeps)} steps "
                f"and had final relative error = {float(aux.em_rel_err):0.9f}"
            )
        elif self.cfg.prior_update == "mle" and not bool(aux.mle_ok):
            # reference logs this on fsolve failure / negative weights
            # (src/sgvamp.py:184,188)
            logger.info("WARNING: MLE solve not accepted. No prior update!")

    def run_scan(
        self,
        iterations: int,
        state: Optional[VampState] = None,
        seed: int = 0,
    ) -> Tuple[VampState, StepAux]:
        """Fully-fused run: lax.scan over iterations, one XLA program."""
        if state is None:
            state = self.init_state(seed)

        @jax.jit
        def scan_fn(s0: VampState, inputs: VampInputs):
            def body(s, _):
                return vamp_step(s, inputs, self.cfg, None)
            return jax.lax.scan(body, s0, None, length=iterations)

        return scan_fn(state, self.inputs)

    def run_scan_stoppable(
        self,
        iterations: int,
        stop_tol: float = 0.0,
        stop_gam1_drop: float = 0.0,
        state: Optional[VampState] = None,
        stop_state: Optional[StopState] = None,
        seed: int = 0,
    ) -> Tuple[VampState, StepAux, StopState]:
        """Fused run with IN-SCAN early stopping.

        Same single-program lax.scan as run_scan, but the scan carry also
        holds a StopState evaluating the StopMonitor criteria on device;
        once a criterion fires every later scan step takes a lax.cond
        no-op branch (the CG solves, denoiser and prior update are all
        skipped), so wall-clock scales with the stopped-at iteration, not
        the requested count — unlike a plain fused scan, which can only
        detect the stop post-hoc after paying for every iteration.

        The PRNG key only advances on executed steps, so the trajectory —
        including the selected iterate — is identical to the host loop's
        (run() with the same stop thresholds). Skipped steps contribute
        all-zero rows to the stacked aux; stop.n_ran tells the caller how
        many leading rows are real.

        stop_state threads the monitor across chunked calls (the fused
        checkpointing path): pass the previous chunk's returned StopState
        so gam1-peak/best-iterate tracking spans chunks.
        """
        if state is None:
            state = self.init_state(seed)
        if stop_state is None:
            stop_state = StopState.create(state.xhat1.shape[0],
                                          self.cfg.jnp_dtype)
        tol, drop = float(stop_tol), float(stop_gam1_drop)
        aux_shape = jax.eval_shape(
            lambda s, i: vamp_step(s, i, self.cfg, None)[1],
            state, self.inputs)

        @jax.jit
        def scan_fn(s0: VampState, mon0: StopState, inputs: VampInputs):
            def live(args):
                s, mon = args
                ns, aux = vamp_step(s, inputs, self.cfg, None)
                mon = stop_state_update(mon, s.it, aux.xhat1, aux.gam1,
                                        tol, drop)
                return ns, mon, aux

            def dead(args):
                s, mon = args
                zero_aux = jax.tree_util.tree_map(
                    lambda sd: jnp.zeros(sd.shape, sd.dtype), aux_shape)
                return s, mon, zero_aux

            def body(carry, _):
                s, mon = carry
                ns, mon, aux = jax.lax.cond(mon.done, dead, live, (s, mon))
                return (ns, mon), aux

            (sN, monN), aux = jax.lax.scan(body, (s0, mon0), None,
                                           length=iterations)
            return sN, aux, monN

        return scan_fn(state, stop_state, self.inputs)

    def write_scan_outputs(
        self,
        aux: StepAux,
        writer: Any,
        Nt: Optional[float] = None,
        x0: Optional[np.ndarray] = None,
        M_out: Optional[int] = None,
        it0: int = 0,
    ) -> Dict[str, Any]:
        """Emit reference-format outputs from a run_scan's stacked aux, so
        fused runs produce the same files as the host loop (post-hoc)."""
        iters = aux.xhat1.shape[0]
        K = aux.r1_in.shape[1]
        scale = 1.0 / np.sqrt(Nt) if Nt else 1.0
        x0v = None if x0 is None else np.asarray(x0).squeeze()
        history: Dict[str, Any] = {"xhat1": [], "alignment": [], "l2": []}
        for rel_it in range(iters):
            it = it0 + rel_it
            xhat1 = np.asarray(aux.xhat1[rel_it])[:M_out]
            history["xhat1"].append(xhat1)
            writer.write_xhat(it, xhat1 * scale)
            lam = float(aux.lam[rel_it])
            for k in range(K):
                writer.write_r1(it, np.asarray(aux.r1_in[rel_it, k])[:M_out] * scale,
                                k + 1)
                writer.write_params([
                    it, float(aux.gamw[rel_it, k]), float(aux.gam1[rel_it, k]),
                    float(aux.gam2[rel_it, k]), float(aux.alpha1[rel_it, k]),
                    float(aux.alpha2[rel_it, k]), lam,
                ], k)
            if x0v is not None:
                alignment, l2 = alignment_l2(xhat1, x0v)
                history["alignment"].append(alignment)
                history["l2"].append(l2)
                writer.write_metrics([it, alignment, l2])
        return history
