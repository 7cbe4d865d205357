"""Multi-device tests on the 8-device virtual CPU mesh: sharded runs must
match unsharded bit-for-bit-ish, and the driver integration points
(__graft_entry__) must compile and execute."""

import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from sgvamp import PriorState, VampConfig, VampEngine, VampInputs
from sgvamp.core.operators import BandedLD, DenseLD
from sgvamp.data.simulate import simulate_ld_band, simulate_multi
from sgvamp.parallel.sharding import make_mesh, shard_inputs, shard_state


def _multi_problem(K=2, N=800, M=256, dtype="float64"):
    rng = np.random.default_rng(0)
    ds = simulate_multi(N, M, K=K, h2=0.8, lam=0.1, rng=rng)
    Rs = np.stack([d.R for d in ds])
    rs = np.stack([d.r for d in ds])
    Nt = float(K * N)
    cfg = VampConfig(prior_update="em", dtype=dtype, cg_maxit=500, cg_rtol=1e-10)
    prior = PriorState.create(0.05, [1.0], [0.01 * Nt])
    inputs = VampInputs(op=DenseLD(mats=jnp.asarray(Rs), s=0.05),
                        r=jnp.asarray(rs), a=jnp.full((K,), 1.0 / K),
                        N=jnp.full((K,), float(N)))
    return inputs, cfg, prior, ds[0].beta * np.sqrt(N), Nt


@pytest.mark.parametrize("K,mesh_shape", [
    (2, (2, 4)), (2, (1, 8)), (2, (2, 1)), (4, (4, 2)),
])
def test_sharded_dense_matches_unsharded(K, mesh_shape):
    inputs, cfg, prior, x0, Nt = _multi_problem(K=K)
    ref = VampEngine(inputs, cfg, prior).run(3, seed=5)
    mesh = make_mesh(*mesh_shape)
    got = VampEngine(inputs, cfg, prior, mesh=mesh).run(3, seed=5)
    for it in range(3):
        np.testing.assert_allclose(got["xhat1"][it], ref["xhat1"][it],
                                   rtol=1e-11, atol=1e-13)
        np.testing.assert_allclose(np.asarray(got["params"][it]),
                                   np.asarray(ref["params"][it]), rtol=1e-9)


def test_sharded_mle_prior_matches_unsharded():
    """MLE prior learning (Newton on the KKT residual) under a mesh: the
    per-iteration mixture weights and trajectories must match unsharded."""
    inputs, cfg, prior, x0, Nt = _multi_problem(K=2)
    cfg = VampConfig(**{**cfg.__dict__, "prior_update": "mle"})
    ref = VampEngine(inputs, cfg, prior).run(3, seed=5)
    got = VampEngine(inputs, cfg, prior, mesh=make_mesh(2, 4)).run(3, seed=5)
    for it in range(3):
        np.testing.assert_allclose(got["xhat1"][it], ref["xhat1"][it],
                                   rtol=1e-11, atol=1e-13)
        np.testing.assert_allclose(np.asarray(got["params"][it]),
                                   np.asarray(ref["params"][it]), rtol=1e-9)


def test_sharded_banded_matches_unsharded():
    rng = np.random.default_rng(1)
    N, M, lam, h2 = 20000, 512, 0.1, 0.7
    band, r, x0 = simulate_ld_band(N, M, bandwidth=48, rng=rng,
                                   dtype=np.float64, h2=h2, lam=lam)
    op = BandedLD.from_band(band, block_size=64)  # nb=8 shards over 4
    cfg = VampConfig(prior_update="em", dtype="float64", cg_maxit=300,
                     cg_rtol=1e-10)
    prior = PriorState.create(lam, [1.0], [h2 / int(M * lam) * N])
    inputs = VampInputs(op=op, r=jnp.asarray(r, jnp.float64)[None],
                        a=jnp.asarray([1.0]), N=jnp.asarray([float(N)]))
    ref = VampEngine(inputs, cfg, prior).run(3, seed=2)
    mesh = make_mesh(1, 4)
    got = VampEngine(inputs, cfg, prior, mesh=mesh).run(3, seed=2)
    for it in range(3):
        np.testing.assert_allclose(got["xhat1"][it], ref["xhat1"][it],
                                   rtol=1e-11, atol=1e-13)


def test_sharded_banded_with_mask_matches_unsharded():
    """Padded banded operator + validity mask under a mesh: padded block
    rows shard cleanly and masked reductions stay exact."""
    rng = np.random.default_rng(4)
    N, M, lam, h2 = 20000, 380, 0.1, 0.7  # pads to 384 = 6 blocks of 64
    band, r, x0 = simulate_ld_band(N, M, bandwidth=40, rng=rng,
                                   dtype=np.float64, h2=h2, lam=lam)
    op = BandedLD.from_band(band, block_size=64)
    Mp = op.M
    mask = np.zeros(Mp)
    mask[:M] = 1.0
    rp = np.zeros(Mp)
    rp[:M] = r
    cfg = VampConfig(prior_update="em", dtype="float64", cg_maxit=300,
                     cg_rtol=1e-10)
    prior = PriorState.create(lam, [1.0], [h2 / int(M * lam) * N])
    inputs = VampInputs(op=op, r=jnp.asarray(rp)[None], a=jnp.asarray([1.0]),
                        N=jnp.asarray([float(N)]), mask=jnp.asarray(mask))
    ref = VampEngine(inputs, cfg, prior).run(3, seed=8, M_out=M)
    mesh = make_mesh(1, 2)
    got = VampEngine(inputs, cfg, prior, mesh=mesh).run(3, seed=8, M_out=M)
    for it in range(3):
        np.testing.assert_allclose(got["xhat1"][it], ref["xhat1"][it],
                                   rtol=1e-11, atol=1e-13)


@pytest.mark.parametrize("mesh_shape,impl", [
    ((1, 4), None), ((1, 2), None), ((1, 4), "interpret"), ((1, 2), "interpret")])
def test_sharded_sym_kernel_matches_unsharded(mesh_shape, impl):
    """The sym operator's shard_map path (halo ppermute + mirror-spill
    ppermute over the marker axis) must reproduce the unsharded trajectory,
    with the CPU's plain reference and with the interpret-mode kernel."""
    import dataclasses

    from sgvamp.ops.band_kernel import SymBandedLD

    rng = np.random.default_rng(9)
    N, M, lam, h2 = 20000, 512, 0.1, 0.7
    band, r, x0 = simulate_ld_band(N, M, bandwidth=100, rng=rng,
                                   dtype=np.float64, h2=h2, lam=lam)
    op = dataclasses.replace(SymBandedLD.from_band(band, block_size=64),
                             impl=impl)  # nb=8, hb=2
    cfg = VampConfig(prior_update="em", dtype="float64", cg_maxit=300,
                     cg_rtol=1e-10)
    prior = PriorState.create(lam, [1.0], [h2 / int(M * lam) * N])
    inputs = VampInputs(op=op, r=jnp.asarray(r, jnp.float64)[None],
                        a=jnp.asarray([1.0]), N=jnp.asarray([float(N)]))
    ref = VampEngine(inputs, cfg, prior).run(3, seed=2)
    mesh = make_mesh(*mesh_shape)
    sharded_inputs = shard_inputs(inputs, mesh)
    assert sharded_inputs.op.mesh is mesh  # shard_map path engaged
    got = VampEngine(inputs, cfg, prior, mesh=mesh).run(3, seed=2)
    for it in range(3):
        np.testing.assert_allclose(got["xhat1"][it], ref["xhat1"][it],
                                   rtol=1e-11, atol=1e-13)
        np.testing.assert_allclose(np.asarray(got["params"][it]),
                                   np.asarray(ref["params"][it]), rtol=1e-9)


@pytest.mark.parametrize("mesh_shape", [(1, 4), (2, 4), (2, 1)])
def test_sharded_sym_int8_matches_unsharded(mesh_shape):
    """The int8 sym operator (per-block scales riding the shard_map) under
    a (cohort, shard) mesh: sharded == unsharded at the f32 level."""
    from sgvamp.ops.band_kernel import SymBandedLD

    rng = np.random.default_rng(11)
    K = mesh_shape[0]
    N, M, lam, h2 = 20000, 1024, 0.05, 0.7
    band, r, x0 = simulate_ld_band(N, M, bandwidth=100, rng=rng,
                                   dtype=np.float64, h2=h2, lam=lam)
    op = SymBandedLD.from_band(band, block_size=128, K=K, dtype="int8")
    rs = np.tile(r[None], (K, 1)) * (1.0 + 0.01 * np.arange(K)[:, None])
    cfg = VampConfig(prior_update="em", dtype="float32", cg_maxit=100,
                     cg_rtol=1e-5, rho=0.5, lmmse_damp=True)
    Nt = float(K * N)
    prior = PriorState.create(lam, [1.0], [h2 / int(M * lam) * Nt])
    inputs = VampInputs(op=op, r=jnp.asarray(rs, jnp.float32),
                        a=jnp.full((K,), 1.0 / K, jnp.float32),
                        N=jnp.full((K,), float(N), jnp.float32))
    iters = 3
    u_seq = (np.random.default_rng(42).integers(0, 2, size=(iters, K, M)) * 2
             - 1).astype(np.float64)
    ref = VampEngine(inputs, cfg, prior).run(iters, fixed_u=u_seq)
    mesh = make_mesh(*mesh_shape)
    sharded_inputs = shard_inputs(inputs, mesh)
    assert sharded_inputs.op.mesh is mesh  # shard_map path engaged
    got = VampEngine(inputs, cfg, prior, mesh=mesh).run(iters, fixed_u=u_seq)
    for it in range(iters):
        a, b = np.asarray(got["xhat1"][it]), np.asarray(ref["xhat1"][it])
        err = np.linalg.norm(a - b) / (np.linalg.norm(b) + 1e-30)
        assert err < 2e-4, f"int8 sharded parity failed at it={it}: {err:.3e}"
        np.testing.assert_allclose(np.asarray(got["params"][it], np.float64),
                                   np.asarray(ref["params"][it], np.float64),
                                   rtol=1e-2)


def test_sharded_sym_multicohort_matches_unsharded():
    """Sym kernel sharded over BOTH axes: K=2 cohorts on the cohort axis,
    block rows on the marker axis."""
    from sgvamp.ops.band_kernel import SymBandedLD

    rng = np.random.default_rng(10)
    N, M, lam, h2 = 20000, 512, 0.1, 0.7
    bands, rs = [], []
    for _ in range(2):
        band, r, _ = simulate_ld_band(N, M, bandwidth=48, rng=rng,
                                      dtype=np.float64, h2=h2, lam=lam)
        bands.append(band)
        rs.append(r)
    ops = [SymBandedLD.from_band(b, block_size=64) for b in bands]
    op = SymBandedLD(upper=jnp.concatenate([o.upper for o in ops], axis=0))
    cfg = VampConfig(prior_update="em", dtype="float64", cg_maxit=300,
                     cg_rtol=1e-10)
    Nt = 2.0 * N
    prior = PriorState.create(lam, [1.0], [h2 / int(M * lam) * Nt])
    inputs = VampInputs(op=op, r=jnp.asarray(np.stack(rs)),
                        a=jnp.full((2,), 0.5), N=jnp.full((2,), float(N)))
    ref = VampEngine(inputs, cfg, prior).run(3, seed=3)
    got = VampEngine(inputs, cfg, prior, mesh=make_mesh(2, 4)).run(3, seed=3)
    for it in range(3):
        np.testing.assert_allclose(got["xhat1"][it], ref["xhat1"][it],
                                   rtol=1e-11, atol=1e-13)


def test_graft_entry_and_dryrun():
    sys.path.insert(0, "/root/repo")
    import __graft_entry__ as g

    fn, args = g.entry()
    out = jax.jit(fn)(*args)
    jax.block_until_ready(out.xhat1)
    assert out.xhat1.shape == (1024,)
    assert bool(jnp.all(jnp.isfinite(out.xhat1)))
    g.dryrun_multichip(8)
    g.dryrun_multichip(2)


def test_shard_state_placement():
    inputs, cfg, prior, _, _ = _multi_problem(K=2, M=2048)
    mesh = make_mesh(2, 4)
    sharded = shard_inputs(inputs, mesh)
    # r (K, M) sharded over both axes
    assert sharded.r.sharding.spec == jax.sharding.PartitionSpec("cohort", "shard")
    from sgvamp.core.vamp import init_state
    st = shard_state(init_state(sharded, cfg, prior, 5.0, 1e-6), mesh)
    assert st.r1.sharding.spec == jax.sharding.PartitionSpec("cohort", "shard")
    assert st.xhat1.sharding.spec == jax.sharding.PartitionSpec("shard")
