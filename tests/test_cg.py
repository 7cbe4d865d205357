"""CG solver tests: scipy parity (solution, iteration count, convergence
info), warm starts, batching with per-lane freezing."""

import jax.numpy as jnp
import numpy as np
import pytest
from scipy.sparse.linalg import cg as scipy_cg

from sgvamp.core.cg import cg_batched


def _spd(rng, M, cond=10.0):
    X = rng.normal(size=(2 * M, M)) / np.sqrt(2 * M)
    return X.T @ X + (1.0 / cond) * np.eye(M)


def test_matches_dense_solve():
    rng = np.random.default_rng(0)
    M = 64
    A = _spd(rng, M)
    b = rng.normal(size=(1, M))
    mv = lambda x: jnp.einsum("ij,kj->ki", jnp.asarray(A), x)
    res = cg_batched(mv, jnp.asarray(b), jnp.zeros((1, M)), maxiter=500, rtol=1e-12)
    expect = np.linalg.solve(A, b[0])
    np.testing.assert_allclose(np.asarray(res.x[0]), expect, rtol=1e-8)
    assert bool(res.converged[0])


@pytest.mark.parametrize("warm", [False, True])
def test_iteration_count_matches_scipy(warm):
    rng = np.random.default_rng(1)
    M = 80
    A = _spd(rng, M, cond=50.0)
    b = rng.normal(size=M)
    x0 = rng.normal(size=M) * 0.1 if warm else np.zeros(M)

    count = {"n": 0}
    scipy_x, info = scipy_cg(
        A, b, x0=x0, maxiter=200, rtol=1e-5, atol=0.0,
        callback=lambda xk: count.__setitem__("n", count["n"] + 1),
    )
    mv = lambda x: jnp.einsum("ij,kj->ki", jnp.asarray(A), x)
    res = cg_batched(mv, jnp.asarray(b)[None], jnp.asarray(x0)[None],
                     maxiter=200, rtol=1e-5, atol=0.0)
    assert info == 0
    assert bool(res.converged[0])
    assert int(res.iters[0]) == count["n"]
    np.testing.assert_allclose(np.asarray(res.x[0]), scipy_x, rtol=1e-6, atol=1e-10)


def test_maxiter_semantics_match_scipy():
    """A lane stopped by maxiter reports unconverged, like scipy info>0."""
    rng = np.random.default_rng(2)
    M = 96
    A = _spd(rng, M, cond=1e4)
    b = rng.normal(size=M)
    maxit = 3
    scipy_x, info = scipy_cg(A, b, maxiter=maxit, rtol=1e-12, atol=0.0)
    mv = lambda x: jnp.einsum("ij,kj->ki", jnp.asarray(A), x)
    res = cg_batched(mv, jnp.asarray(b)[None], jnp.zeros((1, M)),
                     maxiter=maxit, rtol=1e-12)
    assert info > 0 and not bool(res.converged[0])
    assert int(res.iters[0]) == maxit
    np.testing.assert_allclose(np.asarray(res.x[0]), scipy_x, rtol=1e-8)


def test_already_converged_does_zero_iterations():
    rng = np.random.default_rng(3)
    M = 32
    A = _spd(rng, M)
    xstar = rng.normal(size=M)
    b = A @ xstar
    mv = lambda x: jnp.einsum("ij,kj->ki", jnp.asarray(A), x)
    res = cg_batched(mv, jnp.asarray(b)[None], jnp.asarray(xstar)[None],
                     maxiter=100, rtol=1e-5)
    assert int(res.iters[0]) == 0 and bool(res.converged[0])
    np.testing.assert_allclose(np.asarray(res.x[0]), xstar)


def test_force_maxiter_runs_full_budget():
    """force_maxiter executes exactly maxiter iterations on every lane,
    even from an already-converged warm start, without NaNs."""
    rng = np.random.default_rng(7)
    M = 48
    A = _spd(rng, M)
    xstar = rng.normal(size=M)
    b = A @ xstar
    mv = lambda x: jnp.einsum("ij,kj->ki", jnp.asarray(A), x)
    res = cg_batched(mv, jnp.asarray(b)[None], jnp.asarray(xstar)[None],
                     maxiter=25, rtol=1e-5, force_maxiter=True)
    assert int(res.iters[0]) == 25
    assert np.all(np.isfinite(np.asarray(res.x)))
    np.testing.assert_allclose(np.asarray(res.x[0]), xstar, rtol=1e-6)


def test_batched_lanes_freeze_independently():
    """Each lane must produce exactly the trajectory of a solo solve: an
    easy system lane stops early and is untouched while a hard lane runs on."""
    rng = np.random.default_rng(4)
    M = 64
    A_easy = np.eye(M) * 2.0
    A_hard = _spd(rng, M, cond=1e3)
    b = rng.normal(size=(2, M))
    As = jnp.asarray(np.stack([A_easy, A_hard]))
    mv = lambda x: jnp.einsum("kij,kj->ki", As, x)
    res = cg_batched(mv, jnp.asarray(b), jnp.zeros((2, M)), maxiter=300, rtol=1e-10)

    for k, A in enumerate([A_easy, A_hard]):
        solo = cg_batched(
            lambda x: jnp.einsum("ij,kj->ki", jnp.asarray(A), x),
            jnp.asarray(b[k])[None], jnp.zeros((1, M)), maxiter=300, rtol=1e-10,
        )
        assert int(res.iters[k]) == int(solo.iters[0])
        # batched vs solo einsum contract in different orders -> ulp noise
        np.testing.assert_allclose(np.asarray(res.x[k]), np.asarray(solo.x[0]),
                                   rtol=1e-8, atol=1e-10)
    assert int(res.iters[0]) < int(res.iters[1])
