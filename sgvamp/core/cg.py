"""Batched conjugate-gradient solver as a single jit-compatible while loop.

Replaces the reference's two scipy.sparse.linalg.cg calls per iteration
(reference src/sgvamp.py:316,332). The stopping rule mirrors scipy's
(v1.17 `_iterative.py cg`): converge when ||r|| <= max(rtol*||b||, atol),
checked at the top of each iteration, with warm starts honoured.

The solver is *batched* over a leading cohort axis K: all K systems share
one loop, and lanes that have converged are frozen with masks while the
others continue — this keeps the matvec a single large batched
operation instead of K sequential solves. The matvec is passed as a
callable so A = gamw*R + gam2*I is never materialized (unlike reference
src/sgvamp.py:312); scalars fold into the matvec as
A@x = gamw*(R@x) + gam2*x.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, NamedTuple, Optional, Tuple

import jax
import jax.numpy as jnp
from jax import Array


class CGResult(NamedTuple):
    x: Array          # (K, M) solutions
    iters: Array      # (K,) int32, iterations performed per lane
    converged: Array  # (K,) bool, True if tolerance reached before maxiter
    rnorm2: Array     # (K,) final squared residual norms


class _CGState(NamedTuple):
    x: Array       # (K, M)
    r: Array       # (K, M)
    p: Array       # (K, M)
    rz: Array      # (K,) r.z (= r.r when unpreconditioned)
    rn2: Array     # (K,) r.r - the scipy-compatible stopping quantity
    k: Array       # scalar int32, global iteration counter
    iters: Array   # (K,) per-lane iteration counts
    active: Array  # (K,) bool


def _rowdot(x: Array, y: Array) -> Array:
    return jnp.einsum("km,km->k", x, y)


def cg_batched(
    matvec: Callable[[Array], Array],
    b: Array,
    x0: Array,
    maxiter: int,
    rtol: float = 1e-5,
    atol: float = 0.0,
    force_maxiter: bool = False,
    precond: Optional[Callable[[Array], Array]] = None,
) -> CGResult:
    """Solve K independent SPD systems A_k x_k = b_k by masked batched CG.

    Args:
      matvec: (K, M) -> (K, M), applies A_k to row k.
      b:      (K, M) right-hand sides.
      x0:     (K, M) warm starts (reference src/sgvamp.py:316,332).
      maxiter: static max iteration count.
      rtol, atol: scipy-compatible tolerances.
      force_maxiter: run exactly maxiter iterations on every lane
        (deterministic work for benchmarking; also guards against lanes
        freezing on an exactly-zero f32 residual).
      precond: optional (K, M) -> (K, M) SPD preconditioner apply
        z = M^{-1} r (e.g. core.precond block-Jacobi). The stopping rule
        stays on the TRUE residual norm ||r|| (scipy semantics), not the
        preconditioned norm. With precond=None the generated program is
        identical to plain CG.

    Returns:
      CGResult. `converged[k]` matches scipy's `info == 0` semantics:
      a lane that only meets tolerance after its maxiter-th update is
      reported unconverged, as scipy would.
    """
    b = jnp.asarray(b)
    bnorm2 = _rowdot(b, b)
    tol2 = jnp.maximum(rtol * rtol * bnorm2, atol * atol)
    psolve = (lambda v: v) if precond is None else precond

    r0 = b - matvec(x0)
    z0 = psolve(r0)
    rz0 = _rowdot(r0, z0)
    rn0 = rz0 if precond is None else _rowdot(r0, r0)
    active0 = jnp.full(b.shape[0], True) if force_maxiter else rn0 > tol2
    state = _CGState(
        x=x0,
        r=r0,
        p=z0,
        rz=rz0,
        rn2=rn0,
        k=jnp.zeros((), jnp.int32),
        iters=jnp.zeros(b.shape[0], jnp.int32),
        active=active0,
    )

    def cond(s: _CGState) -> Array:
        return (s.k < maxiter) & jnp.any(s.active)

    def body(s: _CGState) -> _CGState:
        ap = matvec(s.p)
        pap = _rowdot(s.p, ap)
        # Guard inactive/degenerate lanes; their updates are masked out below.
        alpha = s.rz / jnp.where(pap == 0.0, 1.0, pap)
        x = s.x + alpha[:, None] * s.p
        r = s.r - alpha[:, None] * ap
        z = psolve(r)
        rz_new = _rowdot(r, z)
        rn_new = rz_new if precond is None else _rowdot(r, r)
        beta = rz_new / jnp.where(s.rz == 0.0, 1.0, s.rz)
        p = z + beta[:, None] * s.p

        if force_maxiter:
            # No lane ever freezes: skip the per-lane masking entirely (it
            # costs three extra (K, M) HBM reads per iteration for masks
            # that are constant-True in this mode).
            rz = rz_new
            rn2 = rn_new
            iters = s.iters + 1
            active = s.active
        else:
            def masked(x, r, p):
                act = s.active[:, None]
                return (jnp.where(act, x, s.x), jnp.where(act, r, s.r),
                        jnp.where(act, p, s.p),
                        jnp.where(s.active, rz_new, s.rz),
                        jnp.where(s.active, rn_new, s.rn2),
                        s.iters + s.active.astype(jnp.int32))

            def unmasked(x, r, p):
                return x, r, p, rz_new, rn_new, s.iters + 1

            # Until the FIRST lane converges the masks are constant-True;
            # branch on that at runtime so production solves (rtol > 0, no
            # force) don't pay the three (K, M) selects every iteration.
            x, r, p, rz, rn2, iters = jax.lax.cond(
                jnp.all(s.active), unmasked, masked, x, r, p)
            active = s.active & (rn2 > tol2)
        return _CGState(x=x, r=r, p=p, rz=rz, rn2=rn2, k=s.k + 1,
                        iters=iters, active=active)

    final = jax.lax.while_loop(cond, body, state)
    # scipy reports info=0 only when the top-of-loop check passed with
    # iteration < maxiter; a lane still active at k == maxiter (or whose
    # residual only dropped below tol on the very last update, which scipy
    # never re-checks) is unconverged.
    converged = jnp.where(
        final.iters < maxiter, jnp.logical_not(final.active), False
    )
    return CGResult(x=final.x, iters=final.iters, converged=converged,
                    rnorm2=final.rn2)
