"""Odds and ends: csr_to_band, the opt-in alpha1 clip, CLI mesh flags,
and the sparse-.npz banded CLI path."""

import numpy as np
import jax.numpy as jnp
import pytest
import scipy.sparse

from sgvamp import PriorState, VampConfig, VampEngine, VampInputs
from sgvamp.cli import main as cli_main
from sgvamp.core.operators import DenseLD
from sgvamp.data import loaders
from sgvamp.data.simulate import band_to_dense, simulate_single


def test_csr_to_band_roundtrip():
    rng = np.random.default_rng(0)
    M = 64
    R = np.zeros((M, M))
    np.fill_diagonal(R, 1.0)
    for d in range(1, 5):
        v = rng.normal(size=M - d)
        R[np.arange(M - d), np.arange(d, M)] = v
        R[np.arange(d, M), np.arange(M - d)] = v
    band, bw, dropped = loaders.csr_to_band(scipy.sparse.csr_matrix(R),
                                            dtype=np.float64)
    assert bw == 4 and dropped == 0
    np.testing.assert_allclose(band_to_dense(band), R)
    # forced narrower bandwidth drops entries
    band2, bw2, dropped2 = loaders.csr_to_band(scipy.sparse.csr_matrix(R),
                                               bandwidth=2, dtype=np.float64)
    assert bw2 == 2 and dropped2 == 2 * (M - 3) + 2 * (M - 4)


def test_cli_npz_banded_matches_dense(tmp_path):
    d = simulate_single(1500, 200, h2=0.8, lam=0.1,
                        rng=np.random.default_rng(0))
    R_sp = np.where(np.abs(d.R) > 0.03, d.R, 0.0)
    np.fill_diagonal(R_sp, 1.0)
    scipy.sparse.save_npz(tmp_path / "R.npz", scipy.sparse.csr_matrix(R_sp))
    np.save(tmp_path / "r.npy", d.r)
    outs = {}
    for op in ["dense", "banded"]:
        out = tmp_path / op
        rc = cli_main.main([
            "--ld-files", str(tmp_path / "R.npz"),
            "--r-files", str(tmp_path / "r.npy"),
            "--out-dir", str(out), "--out-name", "t",
            "--N", "1500", "--M", "200", "--iterations", "3", "--s", "0.2",
            "--platform", "cpu", "--x64", "1", "--operator", op,
            "--block-size", "64", "--seed", "3",
        ])
        assert rc == 0
        outs[op] = np.fromfile(out / "t_xhat_it_2.bin", dtype="<f8")
    np.testing.assert_allclose(outs["banded"], outs["dense"], rtol=1e-8)


def test_cli_mesh_flags(tmp_path):
    d = simulate_single(1000, 128, h2=0.8, lam=0.1,
                        rng=np.random.default_rng(1))
    np.save(tmp_path / "R.npy", d.R)
    np.save(tmp_path / "r.npy", d.r)
    out = tmp_path / "out"
    rc = cli_main.main([
        "--ld-files", str(tmp_path / "R.npy"), "--r-files", str(tmp_path / "r.npy"),
        "--out-dir", str(out), "--out-name", "t",
        "--N", "1000", "--M", "128", "--iterations", "2", "--s", "0.1",
        "--platform", "cpu", "--x64", "1", "--mesh-cohort", "1",
        "--mesh-shard", "4",
    ])
    assert rc == 0
    assert (out / "t_xhat_it_1.bin").exists()


def test_clip_alpha1_optin():
    """clip_alpha1=True (the reference's *intended* clip, quirks #1) must
    change nothing when alpha1 is in range, and bound it when not."""
    d = simulate_single(1000, 100, h2=0.8, lam=0.1,
                        rng=np.random.default_rng(2))
    Nt = 1000.0
    base = dict(dtype="float64", cg_maxit=300, cg_rtol=1e-12)
    prior = PriorState.create(0.1, [1.0], [0.008 * Nt])
    inputs = VampInputs(op=DenseLD(mats=jnp.asarray(d.R)[None], s=0.1),
                        r=jnp.asarray(d.r)[None], a=jnp.asarray([1.0]),
                        N=jnp.asarray([Nt]))
    u = (np.random.default_rng(3).integers(0, 2, (3, 1, 100)) * 2 - 1).astype(float)
    h_off = VampEngine(inputs, VampConfig(**base), prior).run(3, fixed_u=u)
    h_on = VampEngine(inputs, VampConfig(clip_alpha1=True, **base), prior).run(3, fixed_u=u)
    a_off = np.asarray([r[0][4] for r in h_off["params"]])
    a_on = np.asarray([r[0][4] for r in h_on["params"]])
    assert np.all(a_on >= 1e-5 - 1e-12) and np.all(a_on <= 1 - 1e-5 + 1e-12)
    # The default run starts with alpha1 ~ a*gam1*E[dxdb] ~ 1e-6 < 1e-5, so
    # the opt-in clip engages at iteration 0 and the trajectories diverge -
    # i.e. the reference's dead clip (quirks #1) would NOT have been a
    # no-op had it worked; default-off replicates the reference.
    assert not np.allclose(a_on, a_off)


def test_cli_fused_writes_reference_outputs(tmp_path):
    """--fused 1 must now emit the same file set as the host loop."""
    d = simulate_single(1000, 128, h2=0.8, lam=0.1,
                        rng=np.random.default_rng(4))
    np.save(tmp_path / "R.npy", d.R)
    np.save(tmp_path / "r.npy", d.r)
    np.save(tmp_path / "bet.npy", d.beta.reshape(-1, 1))
    out = tmp_path / "out"
    rc = cli_main.main([
        "--ld-files", str(tmp_path / "R.npy"), "--r-files", str(tmp_path / "r.npy"),
        "--true-signal-file", str(tmp_path / "bet.npy"),
        "--out-dir", str(out), "--out-name", "t",
        "--N", "1000", "--M", "128", "--iterations", "3", "--s", "0.1",
        "--platform", "cpu", "--x64", "1", "--fused", "1",
    ])
    assert rc == 0
    import csv as _csv
    rows = list(_csv.reader(open(out / "t_cohort_1.csv"), delimiter="\t"))
    assert len(rows) == 4
    mrows = list(_csv.reader(open(out / "t_metrics.csv"), delimiter="\t"))
    assert len(mrows) == 4
    assert (out / "t_xhat_it_2.bin").exists()
    assert (out / "t_r1_cohort_1_it_0.bin").exists()


def test_rho_anneal_schedule():
    """rho_final annealing: iteration 0 uses rho (no damping applies then
    anyway for xhat1), and by rho_anneal_iters the damping equals
    rho_final; equal endpoints reduce to the fixed-rho run."""
    d = simulate_single(800, 64, h2=0.8, lam=0.1, rng=np.random.default_rng(5))
    Nt = 800.0
    prior = PriorState.create(0.1, [1.0], [0.01 * Nt])
    inputs = VampInputs(op=DenseLD(mats=jnp.asarray(d.R)[None], s=0.1),
                        r=jnp.asarray(d.r)[None], a=jnp.asarray([1.0]),
                        N=jnp.asarray([Nt]))
    u = (np.random.default_rng(6).integers(0, 2, (4, 1, 64)) * 2 - 1).astype(float)
    base = dict(dtype="float64", cg_maxit=200, cg_rtol=1e-12)
    fixed = VampEngine(inputs, VampConfig(rho=0.5, **base), prior).run(4, fixed_u=u)
    same = VampEngine(inputs, VampConfig(rho=0.5, rho_final=0.5,
                                         rho_anneal_iters=2, **base),
                      prior).run(4, fixed_u=u)
    annealed = VampEngine(inputs, VampConfig(rho=0.9, rho_final=0.2,
                                             rho_anneal_iters=3, **base),
                          prior).run(4, fixed_u=u)
    for it in range(4):
        np.testing.assert_allclose(same["xhat1"][it], fixed["xhat1"][it],
                                   rtol=1e-12)
    assert not np.allclose(annealed["xhat1"][-1], fixed["xhat1"][-1])


def test_phase_timers():
    from sgvamp.utils.profiling import PhaseTimers
    import time as _time
    t = PhaseTimers()
    with t.phase("a"):
        _time.sleep(0.01)
    with t.phase("a"):
        pass
    with t.phase("b"):
        pass
    assert t.counts["a"] == 2 and t.counts["b"] == 1
    assert t.totals["a"] >= 0.01
    assert "a: " in t.report() and "2 calls" in t.report()


def test_simulate_phen_bed_reader_fallback(tmp_path):
    """Without the optional bed_reader package the .bed simulator uses
    the vendored PLINK1 reader (data/bed.py) instead of failing (the
    reference hard-imports bed_reader, simulation/sim_phen.py:5). A
    missing file still errors clearly (companion .fam/.bim lookup)."""
    from sgvamp.data.simulate import simulate_from_bed
    try:
        import bed_reader  # noqa: F401
        pytest.skip("bed_reader installed; fallback not exercised")
    except ImportError:
        pass
    with pytest.raises(FileNotFoundError, match=".fam"):
        simulate_from_bed(str(tmp_path / "x.bed"), M=10)
    from sgvamp.data.bed import write_bed
    rng = np.random.default_rng(0)
    write_bed(str(tmp_path / "y.bed"),
              rng.binomial(2, 0.4, size=(20, 10)).astype(np.float64))
    sim = simulate_from_bed(str(tmp_path / "y.bed"), M=10, lam=0.5,
                            rng=np.random.default_rng(1))
    assert sim.r.shape == (10,) and np.all(np.isfinite(sim.r))


def test_alignment_zero_norm_guard():
    """An all-zero xhat1 must produce alignment 0.0, not a NaN metrics
    row (alignment divides by ||xhat1||)."""
    from sgvamp.core.vamp import alignment_l2

    x0 = np.asarray([1.0, 2.0, 3.0])
    al, l2 = alignment_l2(np.zeros(3), x0)
    assert al == 0.0 and np.isfinite(l2)
    al2, l22 = alignment_l2(x0, x0)
    np.testing.assert_allclose([al2, l22], [1.0, 0.0], atol=1e-15)


def test_load_true_signal_strict_length(tmp_path):
    """Wrong-length signal files are rejected, never truncated or
    zero-padded silently (a mismatched panel corrupts every metric)."""
    from sgvamp.data.loaders import load_true_signal

    good = np.arange(8, dtype=np.float64)
    np.save(tmp_path / "x.npy", good)
    got = load_true_signal(str(tmp_path / "x.npy"), 8, 4.0)
    np.testing.assert_allclose(got, good * 2.0)
    for bad_m in (7, 9):
        with pytest.raises(ValueError, match="expected exactly"):
            load_true_signal(str(tmp_path / "x.npy"), bad_m, 4.0)
    import struct

    with open(tmp_path / "x.bin", "wb") as f:
        f.write(struct.pack("8d", *good))
    np.testing.assert_allclose(
        load_true_signal(str(tmp_path / "x.bin"), 8, 4.0), good * 2.0)
    for bad_m in (7, 9):
        with pytest.raises(ValueError, match="expected exactly"):
            load_true_signal(str(tmp_path / "x.bin"), bad_m, 4.0)


def test_spec_for_guards_giant_cohort_axis():
    """The 1-D sharding convention ((K,) vs (M,) by MARKER_VEC_MIN) must
    fail loudly if a mesh's cohort axis reaches the threshold."""
    import jax

    from sgvamp.parallel.sharding import MARKER_VEC_MIN, spec_for

    class FakeMesh:
        shape = {"cohort": MARKER_VEC_MIN, "shard": 1}

    with pytest.raises(AssertionError, match="MARKER_VEC_MIN"):
        spec_for((MARKER_VEC_MIN,), FakeMesh())
    # normal meshes: the convention applies
    from sgvamp.parallel.sharding import make_mesh

    mesh = make_mesh(1, 1, devices=jax.devices()[:1])
    assert spec_for((8,), mesh) == jax.sharding.PartitionSpec("cohort")
    assert spec_for((MARKER_VEC_MIN,), mesh) == jax.sharding.PartitionSpec("shard")
