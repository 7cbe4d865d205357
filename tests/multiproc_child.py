"""Child program for tests/test_multiprocess.py: one jax.distributed
process of a 2-process CPU run (4 virtual devices each), asserting that the
cross-process (cohort, shard) mesh trajectory matches a single-device run
for EVERY shipped LD operator:

  * BandedLD  - the block-banded einsum operator (sharding-propagation
    collectives inserted by XLA),
  * SymBandedLD (f32 / int8) - the symmetric operator running as a
    shard_map with halo + mirror-spill ppermutes riding the cross-process
    (gloo) collective backend - certifying its collectives (including the
    quantization scales leaf) in a genuine multi-process deployment, not
    just on single-process virtual devices, and
  * BlockSparseLD - arbitrary block coordinates (gather/scatter-add
    matvec under sharding propagation).

Also asserts the writer-less aux fetch stays scalar-sized: no (K, M) leaf
may cross processes when nobody reads it (core/vamp.py fetch_aux_full).

Usage: python multiproc_child.py <process_id> <num_processes> <port>
"""

import sys

import jax

jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_num_cpu_devices", 4)
jax.config.update("jax_enable_x64", True)

import numpy as np  # noqa: E402


def run_parity(op_name: str, mesh, nproc: int, fetched_sizes) -> None:
    import jax.numpy as jnp

    from sgvamp.config import VampConfig
    from sgvamp.core.operators import BandedLD
    from sgvamp.core.prior import PriorState
    from sgvamp.core.vamp import VampEngine, VampInputs
    from sgvamp.data.simulate import simulate_ld_band
    from sgvamp.ops.band_kernel import SymBandedLD

    rng = np.random.default_rng(0)
    K, M, B, iters = nproc, 1024, 128, 3
    N = 20000
    band, r, _ = simulate_ld_band(N, M, 64, h2=0.7, lam=0.05, rng=rng,
                                  dtype=np.float64)
    # sym_int8: per-block quantized storage (scales leaf) over the same
    # cross-process shard_map - f32 compute, parity at f32 level.
    # blocksparse: arbitrary block coordinates, sharding-propagation
    # collectives over its gather/scatter-add matvec.
    quant = op_name == "sym_int8"
    if op_name.startswith("sym"):
        op = SymBandedLD.from_band(band, block_size=B, K=K,
                                   dtype="int8" if quant else None)
    elif op_name == "blocksparse":
        import scipy.sparse

        from sgvamp.core.operators import BlockSparseLD
        dense = np.asarray(BandedLD.from_band(band, block_size=B).to_dense()[0])
        op = BlockSparseLD.from_csr(
            [scipy.sparse.csr_matrix(dense)] * K, block_size=B)
    else:
        op = BandedLD.from_band(band, block_size=B, K=K)
    rs = np.tile(r[None], (K, 1)) * (1.0 + 0.01 * np.arange(K)[:, None])
    dt = jnp.float32 if quant else jnp.float64
    cfg = VampConfig(prior_update="em", dtype="float32" if quant else "float64",
                     cg_maxit=100 if quant else 200,
                     cg_rtol=1e-5 if quant else 1e-10, rho=0.5,
                     lmmse_damp=True,
                     # the banded lane also exercises block-Jacobi
                     # preconditioning across processes: the engine's
                     # one-time eigendecomposition cache (precond_q/lam
                     # inputs) must shard over the cross-process mesh
                     **({"cg_precond_block": 64,
                         "cg_precond_dtype": "float64"}
                        if op_name == "banded" else {}))
    Nt = float(K * N)
    cm = max(int(M * 0.05), 1)
    prior = PriorState.create(0.05, [1.0], [0.7 / cm * Nt])
    inputs = VampInputs(
        op=op,
        r=jnp.asarray(rs, dt),
        a=jnp.full((K,), 1.0 / K, dt),
        N=jnp.full((K,), float(N), dt),
    )
    u_seq = (np.random.default_rng(99).integers(0, 2, size=(iters, K, M)) * 2
             - 1).astype(np.float64)

    sharded_engine = VampEngine(inputs, cfg, prior, gamw=5.0, gam1=1e-6,
                                mesh=mesh)
    if op_name == "sym":
        assert sharded_engine.inputs.op.mesh is mesh, (
            "shard_inputs must pin the mesh on SymBandedLD (shard_map path)")
    hist_s = sharded_engine.run(iters, fixed_u=u_seq)

    local_engine = VampEngine(inputs, cfg, prior, gamw=5.0, gam1=1e-6)
    hist_l = local_engine.run(iters, fixed_u=u_seq)

    tol, ptol = (2e-4, 1e-3) if quant else (1e-9, 1e-8)
    for it in range(iters):
        a = np.asarray(hist_s["xhat1"][it])
        b = np.asarray(hist_l["xhat1"][it])
        err = np.linalg.norm(a - b) / (np.linalg.norm(b) + 1e-30)
        assert err < tol, f"[{op_name}] xhat1 parity failed at it={it}: {err:.3e}"
        np.testing.assert_allclose(
            np.asarray(hist_s["params"][it], np.float64),
            np.asarray(hist_l["params"][it], np.float64), rtol=ptol)

    # Writer-less runs must not all-gather any (K, M) aux leaf across
    # processes: the largest fetched array is xhat1 of size M.
    assert fetched_sizes, "fetch spy saw no traffic - wiring broken?"
    assert max(fetched_sizes) <= M, (
        f"[{op_name}] writer-less aux fetch moved an array of size "
        f"{max(fetched_sizes)} > M={M} (r1_in should be skipped)")
    fetched_sizes.clear()


def main() -> int:
    pid, nproc, port = int(sys.argv[1]), int(sys.argv[2]), int(sys.argv[3])

    from sgvamp.parallel.multihost import make_multihost_mesh, multihost_init

    assert multihost_init(f"localhost:{port}", nproc, pid)
    assert jax.process_count() == nproc
    assert len(jax.devices()) == 4 * nproc

    # cohort axis = process count: each host's devices form one shard group,
    # the layout make_multihost_mesh documents.
    mesh = make_multihost_mesh(nproc)
    assert dict(zip(mesh.axis_names, mesh.devices.shape)) == {
        "cohort": nproc, "shard": 4}
    # host-major: row p must be exactly process p's local devices
    for p in range(nproc):
        assert all(d.process_index == p for d in mesh.devices[p]), (
            "multihost mesh rows must align with processes")

    # Spy on the collective aux fetch to prove the writer-less fast path.
    import sgvamp.parallel.multihost as mh

    fetched_sizes = []
    orig_fetch = mh.fetch_global

    def spy_fetch(x):
        fetched_sizes.append(int(np.size(x)))
        return orig_fetch(x)

    mh.fetch_global = spy_fetch

    for op_name in ("banded", "sym", "sym_int8", "blocksparse"):
        run_parity(op_name, mesh, nproc, fetched_sizes)
        print(f"PARITY OK operator={op_name} process={pid}", flush=True)

    run_fetch_agreement(mesh, nproc, pid, fetched_sizes)
    print(f"FETCH-AGREEMENT OK process={pid}", flush=True)
    return 0


def run_fetch_agreement(mesh, nproc: int, pid: int, fetched_sizes) -> None:
    """The fetch_aux_full auto-agreement (core/vamp.py): a writer on
    process 0 ONLY, with no explicit plumbing, must opt every process into
    the full (K, M) aux fetch (collective - an un-agreed fetch would
    deadlock); mismatched explicit values must fail loudly on every
    process instead of hanging."""
    import tempfile

    import jax.numpy as jnp

    from sgvamp.config import VampConfig
    from sgvamp.core.operators import BandedLD
    from sgvamp.core.prior import PriorState
    from sgvamp.core.vamp import VampEngine, VampInputs
    from sgvamp.data.simulate import simulate_ld_band
    from sgvamp.io.writers import OutputWriter

    rng = np.random.default_rng(3)
    K, M, N = nproc, 512, 20000
    band, r, _ = simulate_ld_band(N, M, 32, h2=0.7, lam=0.05, rng=rng,
                                  dtype=np.float64)
    op = BandedLD.from_band(band, block_size=128, K=K)
    inputs = VampInputs(op=op,
                        r=jnp.asarray(np.tile(r[None], (K, 1))),
                        a=jnp.full((K,), 1.0 / K),
                        N=jnp.full((K,), float(N)))
    cfg = VampConfig(prior_update="em", dtype="float64", cg_maxit=50)
    prior = PriorState.create(0.05, [1.0], [0.7 / 25 * N * K])
    engine = VampEngine(inputs, cfg, prior, mesh=mesh)

    writer = None
    if pid == 0:
        writer = OutputWriter(tempfile.mkdtemp(), "agree", K)
    engine.run(1, writer=writer, Nt=float(N * K))
    # every process (writer-holding or not) must have fetched the (K, M)
    # r1_in leaf - the writer's presence was agreed collectively
    assert max(fetched_sizes) >= K * M, (
        f"process {pid} skipped the full aux fetch despite process 0's "
        f"writer (max fetched {max(fetched_sizes)})")
    fetched_sizes.clear()

    # conflicting explicit values: ValueError everywhere, no deadlock
    try:
        engine.run(1, fetch_aux_full=(pid == 0))
    except ValueError as e:
        assert "disagrees across processes" in str(e)
    else:
        raise AssertionError("mismatched fetch_aux_full did not raise")


if __name__ == "__main__":
    sys.exit(main())
