"""Convergence/divergence detection (core.vamp.StopMonitor).

The reference runs a fixed iteration count (reference src/main.py:37) and
leaves iterate selection to the user's post-hoc reading of the metrics CSV
(src/main.py:326-338); iterated past the operating point its recursion
destabilizes and eventually overflows (tests/test_precision.py). These
tests cover the engine's truth-free automation of both: the monitor's
criteria in isolation, and the engine-level behavior on the degenerate
replicated-cohort panel that NaNs an unguarded fixed-count run.
"""

import jax.numpy as jnp
import numpy as np

from sgvamp import (PriorState, StopMonitor, VampConfig, VampEngine,
                    VampInputs)
from sgvamp.core.operators import BandedLD
from sgvamp.data.simulate import simulate_ld_band


def test_monitor_converged():
    mon = StopMonitor(tol=1e-3)
    x = np.ones(16)
    assert mon.update(0, x, np.asarray([1.0])) is None
    assert mon.update(1, x * (1 + 5e-2), np.asarray([2.0])) is None
    # relative change 1e-4 < tol -> converged
    assert mon.update(2, x * (1 + 5e-2 + 1e-4), np.asarray([3.0])) == "converged"
    assert mon.stopped_at == 2 and mon.reason == "converged"


def test_monitor_divergence_keeps_best():
    mon = StopMonitor(gam1_drop=10.0)
    xs = {it: np.full(8, float(it + 1)) for it in range(5)}
    assert mon.update(0, xs[0], np.asarray([1.0, 5.0])) is None   # min=1
    assert mon.update(1, xs[1], np.asarray([100.0, 90.0])) is None  # peak=90
    assert mon.update(2, xs[2], np.asarray([20.0, 30.0])) is None   # 20 > 90/10
    assert mon.update(3, xs[3], np.asarray([8.0, 50.0])) == "diverging"  # 8 < 9
    assert mon.best_it == 1
    np.testing.assert_array_equal(mon.best_xhat1, xs[1])
    # the snapshot is a copy, not a view
    xs[1][:] = -1
    assert mon.best_xhat1[0] == 2.0


def test_monitor_nonfinite_is_divergence():
    mon = StopMonitor(gam1_drop=10.0)
    assert mon.update(0, np.ones(4), np.asarray([5.0])) is None
    assert mon.update(1, np.ones(4), np.asarray([np.nan])) == "diverging"
    assert mon.best_it == 0  # non-finite iterations never become "best"


def test_monitor_off_still_tracks_best():
    mon = StopMonitor()  # both criteria off (reference parity)
    for it, g in enumerate([1.0, 50.0, 2.0, np.nan]):
        assert mon.update(it, np.full(4, it), np.asarray([g])) is None
    assert mon.best_it == 1


def _degenerate_engine(K=8, M=2048):
    """K identical replicated cohorts: the meta denoiser becomes
    overconfident by K, the EM prior collapses, and the unguarded f32
    recursion overflows within ~16 iterations (test_precision.py)."""
    rng = np.random.default_rng(0)
    N, lam, h2 = 300000, 0.01, 0.7
    band, r, x0 = simulate_ld_band(N, M, 64, h2=h2, lam=lam, rng=rng,
                                   dtype=np.float32)
    cm = max(int(M * lam), 1)
    op = BandedLD.from_band(band, block_size=128, dtype="float32", K=K)
    cfg = VampConfig(prior_update="em", dtype="float32", cg_maxit=50,
                     cg_force_maxiter=True, em_prior_maxit=5, rho=0.5,
                     lmmse_damp=True)
    prior = PriorState.create(lam, [1.0], [h2 / cm * N])
    rp = np.tile(r[None], (K, 1))
    inputs = VampInputs(op=op, r=jnp.asarray(rp),
                        a=jnp.full((K,), 1.0 / K, jnp.float32),
                        N=jnp.full((K,), float(N), jnp.float32))
    return VampEngine(inputs, cfg, prior, gamw=5.0, gam1=1e-6), x0


def test_engine_divergence_stop_on_degenerate_panel():
    """The panel that NaNs a fixed-count run must instead stop cleanly
    (reason: diverging) BEFORE the state goes non-finite, with the
    monitor's selected iterate still well-aligned with the truth."""
    engine, x0 = _degenerate_engine()
    # without stopping: the run aborts on non-finite state
    ref = engine.run(16)
    assert "aborted_at" in ref, "panel no longer degenerate; update test"
    # with divergence detection: clean stop, strictly earlier
    hist = engine.run(16, stop_gam1_drop=10.0)
    assert hist.get("stop_reason") == "diverging"
    assert "aborted_at" not in hist
    assert hist["stopped_at"] < ref["aborted_at"]
    best = hist["best_xhat1"]
    assert hist["best_it"] <= hist["stopped_at"]
    assert np.all(np.isfinite(best))
    align = float(best @ x0 / (np.linalg.norm(best) * np.linalg.norm(x0)))
    # the selected iterate sits at the operating point; the final iterate
    # of the fixed-count run has already decayed
    assert align > 0.97
    last = ref["xhat1"][-1]
    align_last = float(last @ x0 / (np.linalg.norm(last) * np.linalg.norm(x0)))
    assert align > align_last


def test_engine_converged_stop():
    """A converged iteration (xhat1 settled) stops on stop_tol. Uses the
    degenerate panel's early plateau: iterations 3-4 change xhat1 by <1%
    (measured) before the later destabilization, so a loose tolerance
    stops there - and must never report the 'diverging' reason."""
    engine, _ = _degenerate_engine()
    hist = engine.run(16, stop_tol=5e-2)
    assert hist.get("stop_reason") == "converged"
    assert hist["stopped_at"] <= 8
    assert np.all(np.isfinite(hist["xhat1"][-1]))


def test_cli_stop_tol_host_loop(tmp_path):
    """--stop-tol stops the host-loop CLI run early: fewer CSV rows than
    the requested iteration count, identical prefix to the full run."""
    from sgvamp.cli import main as cli_main
    from sgvamp.cli import simulate as cli_sim

    d = tmp_path / "sim"
    d.mkdir()
    assert cli_sim.main([
        "gen-phen", "--out", str(d / "s"), "--N", "1500", "--M", "200",
        "--h2", "0.8", "--lam", "0.1", "--seed", "0"]) == 0
    rows = {}
    for name, extra in [("full", []), ("stop", ["--stop-tol", "0.5"])]:
        out = tmp_path / name
        rc = cli_main.main([
            "--ld-files", str(d / "s_R.npy"), "--r-files", str(d / "s_r.npy"),
            "--out-dir", str(out), "--out-name", "t",
            "--N", "1500", "--M", "200", "--iterations", "10",
            "--s", "0.1", "--platform", "cpu", "--x64", "1", "--seed", "1",
            *extra])
        assert rc == 0
        import csv
        with open(out / "t_cohort_1.csv") as f:
            rows[name] = list(csv.reader(f, delimiter="\t"))
    assert len(rows["full"]) == 11  # header + 10 iterations
    assert 1 < len(rows["stop"]) < 11
    # the stopped run's trajectory is a prefix of the full run's
    assert rows["stop"][1:] == rows["full"][1:len(rows["stop"])]
    # a stop-armed run persists the monitor-selected iterate as a file;
    # a parity run (no stop flags) does not
    from sgvamp.io.writers import read_bin
    best = tmp_path / "stop" / "t_xhat_best.bin"
    assert best.exists()
    assert not (tmp_path / "full" / "t_xhat_best.bin").exists()
    best_x = read_bin(str(best), 200)
    per_it = [read_bin(str(tmp_path / "stop" / f"t_xhat_it_{it}.bin"), 200)
              for it in range(len(rows["stop"]) - 1)]  # bins are 0-indexed
    assert any(np.allclose(best_x, x) for x in per_it)


def test_fused_stop_matches_host_loop():
    """In-scan stopping (run_scan_stoppable): same stop iteration, same
    selected iterate as the host loop's StopMonitor, and the aux rows past
    the stop are all-zero (their compute was skipped by the lax.cond)."""
    engine, x0 = _degenerate_engine()
    host = engine.run(16, stop_gam1_drop=10.0)
    st, aux, mon = engine.run_scan_stoppable(16, stop_gam1_drop=10.0)
    assert bool(mon.done)
    assert int(mon.stopped_at) == host["stopped_at"]
    assert int(mon.best_it) == host["best_it"]
    assert int(mon.n_ran) == host["stopped_at"] + 1
    np.testing.assert_allclose(np.asarray(mon.best_xhat1),
                               host["best_xhat1"], rtol=1e-6, atol=1e-8)
    n_ran = int(mon.n_ran)
    # executed rows mirror the host trajectory; skipped rows are zeros
    for i in range(n_ran):
        np.testing.assert_allclose(np.asarray(aux.xhat1[i]),
                                   host["xhat1"][i], rtol=1e-6, atol=1e-8)
    assert not np.any(np.asarray(aux.xhat1[n_ran:]))
    assert not np.any(np.asarray(aux.gam1[n_ran:]))


def test_fused_stop_chunked_threading():
    """StopState threads across chunked scans: two 8-iteration chunks
    reproduce one 16-iteration stoppable scan exactly."""
    engine, _ = _degenerate_engine()
    _, _, mon_one = engine.run_scan_stoppable(16, stop_gam1_drop=10.0)
    st = engine.init_state(0)
    st, aux1, mon = engine.run_scan_stoppable(8, stop_gam1_drop=10.0,
                                              state=st)
    st, aux2, mon = engine.run_scan_stoppable(8, stop_gam1_drop=10.0,
                                              state=st, stop_state=mon)
    assert int(mon.stopped_at) == int(mon_one.stopped_at)
    assert int(mon.best_it) == int(mon_one.best_it)
    assert int(mon.n_ran) == int(mon_one.n_ran)
    np.testing.assert_array_equal(np.asarray(mon.best_xhat1),
                                  np.asarray(mon_one.best_xhat1))


def test_fused_stop_unarmed_never_fires():
    """With both thresholds 0 the stoppable scan runs every iteration and
    reports no stop (reference-parity fixed count)."""
    engine, _ = _degenerate_engine(K=1, M=512)
    _, aux, mon = engine.run_scan_stoppable(4)
    assert not bool(mon.done) and int(mon.n_ran) == 4
    plain_state, plain_aux = engine.run_scan(4)
    np.testing.assert_array_equal(np.asarray(aux.xhat1),
                                  np.asarray(plain_aux.xhat1))


def test_cli_stop_fused_chunked(tmp_path):
    """--stop-tol with --fused 1 + --checkpoint-dir: the in-scan monitor
    stops mid-chunk, outputs end exactly where the host loop's do, and
    nothing past the stop iteration reaches disk (the chunk's remaining
    iterations are skipped on device)."""
    from sgvamp.cli import main as cli_main
    from sgvamp.cli import simulate as cli_sim

    d = tmp_path / "sim"
    d.mkdir()
    assert cli_sim.main([
        "gen-phen", "--out", str(d / "s"), "--N", "1500", "--M", "200",
        "--h2", "0.8", "--lam", "0.1", "--seed", "0"]) == 0
    base = ["--ld-files", str(d / "s_R.npy"), "--r-files", str(d / "s_r.npy"),
            "--N", "1500", "--M", "200", "--iterations", "10",
            "--s", "0.1", "--platform", "cpu", "--x64", "1", "--seed", "1",
            "--stop-tol", "0.5"]
    out_host = tmp_path / "host"
    assert cli_main.main(base + ["--out-dir", str(out_host),
                                 "--out-name", "t"]) == 0
    out = tmp_path / "out"
    rc = cli_main.main(base + [
        "--out-dir", str(out), "--out-name", "t",
        "--fused", "1", "--checkpoint-dir", str(tmp_path / "ck"),
        "--checkpoint-every", "4"])
    assert rc == 0
    import csv

    def rows(p):
        with open(p / "t_cohort_1.csv") as f:
            return list(csv.reader(f, delimiter="\t"))
    host_rows, fused_rows = rows(out_host), rows(out)
    assert len(fused_rows) == len(host_rows) < 11
    assert (len(fused_rows) - 1) % 4 != 0  # genuinely mid-chunk
    # no xhat bin exists past the stop iteration
    n = len(fused_rows) - 1
    assert (out / f"t_xhat_it_{n - 1}.bin").exists()
    assert not (out / f"t_xhat_it_{n}.bin").exists()
    # the selected-iterate file matches the host loop's
    from sgvamp.io.writers import read_bin
    np.testing.assert_allclose(
        read_bin(str(out / "t_xhat_best.bin"), 200),
        read_bin(str(out_host / "t_xhat_best.bin"), 200), rtol=1e-12)


def test_fused_stop_sharded_matches_unsharded():
    """run_scan_stoppable under a (cohort, shard) mesh: the on-device
    StopState (prev/best xhat1 are (M,) leaves riding sharding
    propagation) must reproduce the unsharded stop decision and selected
    iterate."""
    from sgvamp.parallel.sharding import make_mesh

    engine, _ = _degenerate_engine(K=2, M=1024)
    _, _, mon_ref = engine.run_scan_stoppable(16, stop_gam1_drop=10.0)
    assert bool(mon_ref.done)

    from sgvamp.core.vamp import VampEngine
    sharded = VampEngine(engine.inputs, engine.cfg, engine.prior,
                         gamw=engine.gamw0, gam1=engine.gam10,
                         mesh=make_mesh(2, 4))
    _, _, mon = sharded.run_scan_stoppable(16, stop_gam1_drop=10.0)
    assert int(mon.stopped_at) == int(mon_ref.stopped_at)
    assert int(mon.best_it) == int(mon_ref.best_it)
    assert int(mon.n_ran) == int(mon_ref.n_ran)
    a = np.asarray(mon.best_xhat1)
    b = np.asarray(mon_ref.best_xhat1)
    err = np.linalg.norm(a - b) / (np.linalg.norm(b) + 1e-30)
    assert err < 1e-5, f"sharded best iterate mismatch: {err:.3e}"


def test_stop_state_no_converged_on_nonfinite():
    """Parity with StopMonitor: convergence is never reported on an
    iteration whose gam1 is non-finite, even if xhat1 barely changed
    (the host monitor's `not finite` branch short-circuits the tol
    check; tol-only runs then surface the non-finite state instead of a
    clean 'converged')."""
    from sgvamp.core.vamp import StopState, stop_state_update

    x = jnp.ones(16)
    mon = StopState.create(16, jnp.float32)
    mon = stop_state_update(mon, jnp.asarray(0), x, jnp.asarray([5.0]),
                            tol=1e-3, gam1_drop=0.0)
    assert not bool(mon.done)
    mon = stop_state_update(mon, jnp.asarray(1), x * (1 + 1e-6),
                            jnp.asarray([jnp.nan]), tol=1e-3, gam1_drop=0.0)
    assert not bool(mon.done), "converged fired on a non-finite iteration"
    # host monitor agrees
    host = StopMonitor(tol=1e-3)
    assert host.update(0, np.ones(16), np.asarray([5.0])) is None
    assert host.update(1, np.ones(16) * (1 + 1e-6),
                       np.asarray([np.nan])) is None


def test_cli_fused_armed_resume_completed(tmp_path):
    """Re-running a COMPLETED armed fused checkpointed run with --resume
    must exit cleanly (no chunk executes; there is no stop state)."""
    from sgvamp.cli import main as cli_main
    from sgvamp.cli import simulate as cli_sim

    d = tmp_path / "sim"
    d.mkdir()
    assert cli_sim.main([
        "gen-phen", "--out", str(d / "s"), "--N", "1500", "--M", "200",
        "--h2", "0.8", "--lam", "0.1", "--seed", "0"]) == 0
    args = ["--ld-files", str(d / "s_R.npy"), "--r-files", str(d / "s_r.npy"),
            "--out-dir", str(tmp_path / "out"), "--out-name", "t",
            "--N", "1500", "--M", "200", "--iterations", "4",
            "--s", "0.1", "--platform", "cpu", "--x64", "1", "--seed", "1",
            "--fused", "1", "--checkpoint-dir", str(tmp_path / "ck"),
            "--checkpoint-every", "2", "--stop-tol", "1e-12"]
    assert cli_main.main(args) == 0
    assert cli_main.main(args + ["--resume", "1"]) == 0  # crashed pre-fix
