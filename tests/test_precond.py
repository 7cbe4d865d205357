"""Block-Jacobi preconditioned CG tests: solution parity with plain CG /
dense solves, a strict iteration-count win on banded LD systems, operator
diag_blocks() correctness, and full-engine trajectory parity with the
preconditioner enabled (single-device and sharded).

The reference has no preconditioner at all (its scipy cg calls are plain,
reference src/sgvamp.py:316,332) - this capability beats it outright on
time-to-tolerance.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from sgvamp.config import VampConfig
from sgvamp.core.cg import cg_batched
from sgvamp.core.operators import BandedLD, BlockSparseLD, DenseLD
from sgvamp.core.precond import apply_block_jacobi, block_jacobi_inverse
from sgvamp.core.prior import PriorState
from sgvamp.core.vamp import VampEngine, VampInputs
from sgvamp.data.simulate import simulate_ld_band
from sgvamp.ops.band_kernel import SymBandedLD


def _problem(M=1024, bw=96, B=128, seed=0, s=0.05):
    rng = np.random.default_rng(seed)
    band, r, x0 = simulate_ld_band(20000, M, bandwidth=bw, rng=rng,
                                   dtype=np.float64, h2=0.7, lam=0.05)
    op = SymBandedLD.from_band(band, block_size=B, s=s)
    return op, band, r, x0


def _amatvec(op, gamw, gam2):
    def mv(x):
        return gamw[:, None] * op.matvec(x) + gam2[:, None] * x
    return mv


def test_pcg_same_solution_fewer_iterations():
    """At tight rtol the preconditioned solve returns the same solution as
    plain CG (both match the dense solve) in strictly fewer iterations."""
    op, band, r, _ = _problem()
    K, M = 1, op.M
    gamw = jnp.asarray([40.0])
    gam2 = jnp.asarray([1.0])
    b = jnp.asarray(np.tile(r[None], (K, 1)))
    mv = _amatvec(op, gamw, gam2)

    plain = cg_batched(mv, b, jnp.zeros((K, M)), maxiter=800, rtol=1e-10)
    pinv = block_jacobi_inverse(op, gamw, gam2)
    pre = cg_batched(mv, b, jnp.zeros((K, M)), maxiter=800, rtol=1e-10,
                     precond=lambda v: apply_block_jacobi(pinv, v))

    A = np.asarray(op.to_dense()[0], np.float64) * float(gamw[0])
    A += float(gam2[0]) * np.eye(M)
    want = np.linalg.solve(A, np.asarray(b[0]))
    scale = np.linalg.norm(want)
    assert bool(plain.converged[0]) and bool(pre.converged[0])
    np.testing.assert_allclose(np.asarray(plain.x[0]) / scale, want / scale,
                               atol=1e-9)
    np.testing.assert_allclose(np.asarray(pre.x[0]) / scale, want / scale,
                               atol=1e-9)
    # the whole point: fewer LD passes to the same tolerance
    assert int(pre.iters[0]) < int(plain.iters[0]), (
        f"precond {int(pre.iters[0])} vs plain {int(plain.iters[0])}")


@pytest.mark.parametrize("sub_block", [32, 64, 128])
def test_pcg_sub_blocks_converge(sub_block):
    """Any sub-block size that divides B yields a valid SPD preconditioner:
    same solution, never more iterations than plain CG on this system."""
    op, band, r, _ = _problem()
    gamw = jnp.asarray([40.0])
    gam2 = jnp.asarray([1.0])
    b = jnp.asarray(r[None])
    mv = _amatvec(op, gamw, gam2)
    plain = cg_batched(mv, b, jnp.zeros((1, op.M)), maxiter=800, rtol=1e-8)
    pinv = block_jacobi_inverse(op, gamw, gam2, sub_block)
    assert pinv.shape == (1, op.M // sub_block, sub_block, sub_block)
    pre = cg_batched(mv, b, jnp.zeros((1, op.M)), maxiter=800, rtol=1e-8,
                     precond=lambda v: apply_block_jacobi(pinv, v))
    assert bool(pre.converged[0])
    assert int(pre.iters[0]) <= int(plain.iters[0])
    # both stopped at rtol=1e-8, so the iterates agree only to ~that level
    np.testing.assert_allclose(np.asarray(pre.x[0]), np.asarray(plain.x[0]),
                               rtol=1e-4, atol=1e-7)


@pytest.mark.parametrize("setup_chunk", [8, 3])
def test_chunked_setup_matches_unchunked(setup_chunk):
    """The lax.map-chunked shift+invert (the K=8 x M=1M OOM fix) returns
    the same inverse blocks as the single batched inv, including when the
    chunk does not divide K*nb (identity-padded tail, chunk=3)."""
    op, band, r, _ = _problem(M=1024, bw=96, B=128)
    gamw = jnp.asarray([40.0])
    gam2 = jnp.asarray([1.0])
    for sub in (64, 128):
        full = block_jacobi_inverse(op, gamw, gam2, sub, setup_chunk=0)
        chunked = block_jacobi_inverse(op, gamw, gam2, sub,
                                       setup_chunk=setup_chunk)
        assert chunked.shape == full.shape
        np.testing.assert_allclose(np.asarray(chunked), np.asarray(full),
                                   rtol=1e-6, atol=1e-7)


def test_chunked_setup_multi_cohort_scalars():
    """Chunking flattens the (K, nb) batch; per-cohort gamw/gam2 must stay
    attached to their own cohort's blocks."""
    op, band, r, _ = _problem(M=512, bw=48, B=64)
    K = 3
    mats = jnp.tile(op.to_dense(), (K, 1, 1)) * (1 / (1 - 0.05))
    mats = mats - 0.05 / (1 - 0.05) * jnp.eye(op.M)[None]
    dense = DenseLD(mats=mats, s=0.05)
    gamw = jnp.asarray([40.0, 7.0, 120.0])
    gam2 = jnp.asarray([1.0, 3.0, 0.2])
    full = block_jacobi_inverse(dense, gamw, gam2, 64, setup_chunk=0)
    chunked = block_jacobi_inverse(dense, gamw, gam2, 64, setup_chunk=5)
    np.testing.assert_allclose(np.asarray(chunked), np.asarray(full),
                               rtol=1e-6, atol=1e-7)


def test_identity_precond_is_plain_cg():
    """With identity inverse blocks the preconditioned path must reproduce
    plain CG exactly (same iterations, same iterates)."""
    op, band, r, _ = _problem(M=512, bw=48, B=64)
    gamw = jnp.asarray([10.0])
    gam2 = jnp.asarray([0.5])
    b = jnp.asarray(r[None])
    mv = _amatvec(op, gamw, gam2)
    plain = cg_batched(mv, b, jnp.zeros((1, op.M)), maxiter=400, rtol=1e-9)
    eye = jnp.tile(jnp.eye(64, dtype=jnp.float64)[None, None],
                   (1, op.M // 64, 1, 1))
    pre = cg_batched(mv, b, jnp.zeros((1, op.M)), maxiter=400, rtol=1e-9,
                     precond=lambda v: apply_block_jacobi(eye, v))
    assert int(pre.iters[0]) == int(plain.iters[0])
    np.testing.assert_allclose(np.asarray(pre.x[0]), np.asarray(plain.x[0]),
                               rtol=1e-12)


def test_diag_blocks_match_dense_all_operators():
    """Every operator's diag_blocks() must equal the diagonal blocks of its
    own to_dense() (regularization included)."""
    rng = np.random.default_rng(5)
    M, bw, B, s = 512, 48, 64, 0.1
    band, _, _ = simulate_ld_band(20000, M, bandwidth=bw, rng=rng,
                                  dtype=np.float64)
    sym = SymBandedLD.from_band(band, block_size=B, s=s)
    banded = BandedLD.from_band(band, block_size=B, s=s)
    dense = DenseLD(mats=banded.to_dense() * (1 / (1 - s))
                    - s / (1 - s) * jnp.eye(M)[None], s=s)
    import scipy.sparse

    R = scipy.sparse.csr_matrix(np.asarray(
        sym.to_dense()[0] * (1 / (1 - s)) - s / (1 - s) * np.eye(M)))
    bsp = BlockSparseLD.from_csr([R], block_size=B, s=s)

    for name, op in [("sym", sym), ("banded", banded),
                     ("blocksparse", bsp)]:
        D = np.asarray(op.diag_blocks(), np.float64)
        dn = np.asarray(op.to_dense()[0], np.float64)
        nb = op.M // op.B
        want = np.stack([dn[i * op.B:(i + 1) * op.B, i * op.B:(i + 1) * op.B]
                         for i in range(nb)])
        np.testing.assert_allclose(D[0], want, rtol=1e-6, atol=1e-7,
                                   err_msg=name)
    # DenseLD picks its own block default
    Dd = np.asarray(dense.diag_blocks(64), np.float64)
    dnd = np.asarray(dense.to_dense()[0], np.float64)
    want = np.stack([dnd[i * 64:(i + 1) * 64, i * 64:(i + 1) * 64]
                     for i in range(M // 64)])
    np.testing.assert_allclose(Dd[0], want, rtol=1e-6, atol=1e-7)


def test_diag_blocks_int8_dequantized():
    op, band, r, _ = _problem(M=512, bw=48, B=64, s=0.0)
    q = SymBandedLD.from_band(band, block_size=64, dtype="int8")
    D = np.asarray(q.diag_blocks(), np.float64)
    dn = np.asarray(q.to_dense()[0], np.float64)
    want = np.stack([dn[i * 64:(i + 1) * 64, i * 64:(i + 1) * 64]
                     for i in range(q.M // 64)])
    np.testing.assert_allclose(D[0], want, rtol=1e-5, atol=1e-6)


def _engine(op, r, cfg, N=20000):
    K = 1
    prior = PriorState.create(0.05, [1.0], [0.7 / max(int(1024 * 0.05), 1) * N])
    inputs = VampInputs(op=op, r=jnp.asarray(r[None]),
                        a=jnp.asarray([1.0]), N=jnp.asarray([float(N)]))
    return VampEngine(inputs, cfg, prior)


def test_engine_trajectory_parity_with_precond():
    """Full VAMP runs with and without the preconditioner follow the same
    trajectory at tight CG tolerance (the solves agree, so everything
    downstream agrees), while logging fewer CG iterations."""
    op, band, r, x0 = _problem()
    iters = 4
    u_seq = (np.random.default_rng(42).integers(0, 2, size=(iters, 1, op.M))
             * 2 - 1).astype(np.float64)
    base = dict(prior_update="em", dtype="float64", cg_maxit=800,
                cg_rtol=1e-10, rho=0.5, lmmse_damp=True)
    h_plain = _engine(op, r, VampConfig(**base)).run(iters, fixed_u=u_seq)
    h_pre = _engine(op, r, VampConfig(**base, cg_precond_block=128,
                                      cg_precond_dtype="float64")).run(
        iters, fixed_u=u_seq)
    for it in range(iters):
        a, b = h_pre["xhat1"][it], h_plain["xhat1"][it]
        err = np.linalg.norm(a - b) / (np.linalg.norm(b) + 1e-30)
        assert err < 1e-7, f"trajectory diverged at it={it}: {err:.3e}"
    total_plain = sum(int(np.max(i)) for i in h_plain["cg1_iters"])
    total_pre = sum(int(np.max(i)) for i in h_pre["cg1_iters"])
    assert total_pre < total_plain, (total_pre, total_plain)


def test_engine_precond_sharded_matches_unsharded():
    """The preconditioner build (diag_blocks + batched inverse) and apply
    must survive the (cohort, shard) mesh: sharded == unsharded."""
    from sgvamp.parallel.sharding import make_mesh

    op, band, r, x0 = _problem()
    iters = 3
    u_seq = (np.random.default_rng(17).integers(0, 2, size=(iters, 1, op.M))
             * 2 - 1).astype(np.float64)
    cfg = VampConfig(prior_update="em", dtype="float64", cg_maxit=400,
                     cg_rtol=1e-10, rho=0.5, lmmse_damp=True,
                     cg_precond_block=128, cg_precond_dtype="float64")
    prior = PriorState.create(0.05, [1.0], [0.7 / 51 * 20000.0])
    inputs = VampInputs(op=op, r=jnp.asarray(r[None]),
                        a=jnp.asarray([1.0]), N=jnp.asarray([20000.0]))
    h_local = VampEngine(inputs, cfg, prior).run(iters, fixed_u=u_seq)
    mesh = make_mesh(1, 4)
    h_shard = VampEngine(inputs, cfg, prior, mesh=mesh).run(iters,
                                                            fixed_u=u_seq)
    for it in range(iters):
        a, b = h_shard["xhat1"][it], h_local["xhat1"][it]
        err = np.linalg.norm(a - b) / (np.linalg.norm(b) + 1e-30)
        assert err < 1e-9, f"sharded mismatch at it={it}: {err:.3e}"


def test_eig_cache_matches_direct_inverse():
    """block_jacobi_from_eig(Q, lam) must equal block_jacobi_inverse for
    any (gamw, gam2) - the scalars enter only through the eigenvalues."""
    from sgvamp.core.precond import block_jacobi_eig, block_jacobi_from_eig

    op, band, r, _ = _problem(M=1024, bw=96, B=128)
    Q, lam = block_jacobi_eig(op, 64)
    for gw, g2 in [(40.0, 1.0), (3.0, 17.0)]:
        gamw, gam2 = jnp.asarray([gw]), jnp.asarray([g2])
        want = block_jacobi_inverse(op, gamw, gam2, 64)
        got = block_jacobi_from_eig(Q, lam, gamw, gam2)
        np.testing.assert_allclose(np.asarray(got), np.asarray(want),
                                   rtol=1e-5, atol=1e-7)
    # chunked eigh path (forcing chunking incl. a padded tail)
    Qc, lamc = block_jacobi_eig(op, 64, setup_chunk=3)
    got = block_jacobi_from_eig(Qc, lamc, jnp.asarray([40.0]),
                                jnp.asarray([1.0]))
    want = block_jacobi_inverse(op, jnp.asarray([40.0]), jnp.asarray([1.0]),
                                64)
    np.testing.assert_allclose(np.asarray(got), np.asarray(want),
                               rtol=1e-5, atol=1e-7)


def test_engine_eig_cache_trajectory_matches_direct():
    """The engine's cached-eig rebuild follows the same trajectory as the
    in-step direct inversion (cg_precond_eig=False)."""
    op, band, r, x0 = _problem()
    iters = 3
    u_seq = (np.random.default_rng(5).integers(0, 2, size=(iters, 1, op.M))
             * 2 - 1).astype(np.float64)
    base = dict(prior_update="em", dtype="float64", cg_maxit=800,
                cg_rtol=1e-10, rho=0.5, lmmse_damp=True,
                cg_precond_block=64, cg_precond_dtype="float64")
    h_eig = _engine(op, r, VampConfig(**base)).run(iters, fixed_u=u_seq)
    h_lu = _engine(op, r, VampConfig(**base, cg_precond_eig=False)).run(
        iters, fixed_u=u_seq)
    for it in range(iters):
        a, b = h_eig["xhat1"][it], h_lu["xhat1"][it]
        err = np.linalg.norm(a - b) / (np.linalg.norm(b) + 1e-30)
        assert err < 1e-8, f"eig/direct diverged at it={it}: {err:.3e}"


def test_engine_precond_with_int8_operator():
    """The eig-cached preconditioner over int8 LD storage (diag_blocks
    dequantizes the d=0 blocks): the preconditioned run converges its
    solves and tracks the plain run."""
    rng = np.random.default_rng(8)
    band, r, x0 = simulate_ld_band(20000, 1024, bandwidth=96, rng=rng,
                                   dtype=np.float32, h2=0.7, lam=0.05)
    op = SymBandedLD.from_band(band, block_size=128, s=0.05, dtype="int8")
    iters = 3
    u_seq = (np.random.default_rng(4).integers(0, 2, size=(iters, 1, op.M))
             * 2 - 1).astype(np.float64)
    base = dict(prior_update="em", dtype="float32", cg_maxit=300,
                cg_rtol=1e-6, rho=0.5, lmmse_damp=True)
    N = 20000.0
    prior = PriorState.create(0.05, [1.0], [0.7 / 51 * N],
                              dtype=jnp.float32)
    inputs = VampInputs(op=op, r=jnp.asarray(r, jnp.float32)[None],
                        a=jnp.asarray([1.0], jnp.float32),
                        N=jnp.asarray([N], jnp.float32))
    h_plain = VampEngine(inputs, VampConfig(**base), prior).run(
        iters, fixed_u=u_seq)
    h_pre = VampEngine(inputs, VampConfig(**base, cg_precond_block=64,
                                          cg_precond_dtype="float32"),
                       prior).run(iters, fixed_u=u_seq)
    for it in range(iters):
        a, b = h_pre["xhat1"][it], h_plain["xhat1"][it]
        err = np.linalg.norm(a - b) / (np.linalg.norm(b) + 1e-30)
        # f32 compute over quantized blocks: the two CG paths agree to
        # the storage-noise class, not to the cg_rtol
        assert err < 1e-2, f"int8 precond diverged at it={it}: {err:.3e}"
    assert int(np.max(h_pre["cg1_iters"][-1])) <= int(
        np.max(h_plain["cg1_iters"][-1]))
