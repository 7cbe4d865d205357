"""End-to-end CLI tests: simulate -> infer -> plot, covering the
reference's full user workflow (SURVEY 3.1/3.3/3.5) in one process,
plus checkpoint/resume and the banded-operator path."""

import csv

import numpy as np
import pytest

from sgvamp.cli import main as cli_main
from sgvamp.cli import plots as cli_plots
from sgvamp.cli import simulate as cli_sim
from sgvamp.cli import vis_ld as cli_vis


@pytest.fixture(scope="module")
def sim_dir(tmp_path_factory):
    d = tmp_path_factory.mktemp("sim")
    rc = cli_sim.main([
        "gen-phen", "--out", str(d / "sim"), "--N", "1500", "--M", "200",
        "--h2", "0.8", "--lam", "0.1", "--seed", "0",
    ])
    assert rc == 0
    return d


def _read_csv(path):
    with open(path) as f:
        rows = list(csv.reader(f, delimiter="\t"))
    return rows


def test_cli_end_to_end_single_cohort(sim_dir, tmp_path):
    out = tmp_path / "out"
    rc = cli_main.main([
        "--ld-files", str(sim_dir / "sim_R.npy"),
        "--r-files", str(sim_dir / "sim_r.npy"),
        "--true-signal-file", str(sim_dir / "sim_bet.npy"),
        "--out-dir", str(out), "--out-name", "t",
        "--N", "1500", "--M", "200", "--iterations", "5",
        "--s", "0.1", "--platform", "cpu", "--x64", "1",
    ])
    assert rc == 0
    rows = _read_csv(out / "t_cohort_1.csv")
    assert rows[0] == ["it", "gamw", "gam1", "gam2", "alpha1", "alpha2", "lam"]
    assert len(rows) == 6
    mrows = _read_csv(out / "t_metrics.csv")
    assert len(mrows) == 6
    # alignment should reach a sensible level on this easy problem
    final_align = float(mrows[-1][1])
    assert final_align > 0.9
    assert (out / "t_xhat_it_4.bin").exists()
    assert (out / "t_r1_cohort_1_it_4.bin").exists()
    xh = np.fromfile(out / "t_xhat_it_4.bin", dtype="<f8")
    assert xh.shape == (200,)


def test_cli_banded_operator_matches_dense(sim_dir, tmp_path):
    """Banded and sym operators with full bandwidth must reproduce the
    dense run."""
    outs = {}
    for op in ["dense", "banded", "sym"]:
        out = tmp_path / op
        rc = cli_main.main([
            "--ld-files", str(sim_dir / "sim_R.npy"),
            "--r-files", str(sim_dir / "sim_r.npy"),
            "--out-dir", str(out), "--out-name", "t",
            "--N", "1500", "--M", "200", "--iterations", "3",
            "--s", "0.1", "--platform", "cpu", "--x64", "1",
            "--operator", op, "--block-size", "64", "--bandwidth", "200",
            "--seed", "7",
        ])
        assert rc == 0
        outs[op] = np.fromfile(out / "t_xhat_it_2.bin", dtype="<f8")
    np.testing.assert_allclose(outs["banded"], outs["dense"], rtol=1e-8, atol=1e-12)
    np.testing.assert_allclose(outs["sym"], outs["dense"], rtol=1e-8, atol=1e-12)


def test_cli_sym_operator_sharded_matches_unsharded(sim_dir, tmp_path):
    """--operator sym with a marker-shard mesh runs the pallas kernel under
    shard_map (halo/spill ppermutes) and must reproduce the unsharded run."""
    outs = {}
    for name, extra in [("plain", []), ("sharded", ["--mesh-shard", "2"])]:
        out = tmp_path / name
        rc = cli_main.main([
            "--ld-files", str(sim_dir / "sim_R.npy"),
            "--r-files", str(sim_dir / "sim_r.npy"),
            "--out-dir", str(out), "--out-name", "t",
            "--N", "1500", "--M", "200", "--iterations", "3",
            "--s", "0.1", "--platform", "cpu", "--x64", "1",
            "--operator", "sym", "--block-size", "64", "--bandwidth", "100",
            "--seed", "7", *extra,
        ])
        assert rc == 0
        outs[name] = np.fromfile(out / "t_xhat_it_2.bin", dtype="<f8")
    np.testing.assert_allclose(outs["sharded"], outs["plain"],
                               rtol=1e-10, atol=1e-13)


def test_cli_ld_dtype_bf16(sim_dir, tmp_path):
    """--ld-dtype bfloat16 stores LD blocks at half width (f32 accumulate);
    the run must stay close to the float32 run on an easy problem."""
    aligns = {}
    for name, extra in [("f32", []), ("bf16", ["--ld-dtype", "bfloat16"])]:
        out = tmp_path / name
        rc = cli_main.main([
            "--ld-files", str(sim_dir / "sim_R.npy"),
            "--r-files", str(sim_dir / "sim_r.npy"),
            "--true-signal-file", str(sim_dir / "sim_bet.npy"),
            "--out-dir", str(out), "--out-name", "t",
            "--N", "1500", "--M", "200", "--iterations", "5",
            "--s", "0.1", "--platform", "cpu", "--dtype", "float32",
            "--x64", "0", "--operator", "banded", "--block-size", "64",
            "--bandwidth", "200", "--seed", "7",
        ] + extra)
        assert rc == 0
        aligns[name] = float(_read_csv(out / "t_metrics.csv")[-1][1])
    assert aligns["bf16"] > 0.9
    assert abs(aligns["bf16"] - aligns["f32"]) < 0.02


def test_cli_ld_dtype_int8(sim_dir, tmp_path):
    """--ld-dtype int8 with --operator sym: per-block quantized LD storage
    (quarter the f32 HBM traffic) must stay close to the float32 run."""
    aligns = {}
    for name, extra in [("f32", []), ("int8", ["--ld-dtype", "int8"])]:
        out = tmp_path / name
        rc = cli_main.main([
            "--ld-files", str(sim_dir / "sim_R.npy"),
            "--r-files", str(sim_dir / "sim_r.npy"),
            "--true-signal-file", str(sim_dir / "sim_bet.npy"),
            "--out-dir", str(out), "--out-name", "t",
            "--N", "1500", "--M", "200", "--iterations", "5",
            "--s", "0.1", "--platform", "cpu", "--dtype", "float32",
            "--x64", "0", "--operator", "sym", "--block-size", "64",
            "--bandwidth", "200", "--seed", "7",
        ] + extra)
        assert rc == 0
        aligns[name] = float(_read_csv(out / "t_metrics.csv")[-1][1])
    assert aligns["int8"] > 0.9
    assert abs(aligns["int8"] - aligns["f32"]) < 0.02


def test_cli_stability_guards(sim_dir, tmp_path):
    """--clip-alpha1/--clip-alpha2/--gam-clamp (opt-in stability guards the
    reference lacks) must not perturb a well-behaved run's trajectory:
    inside the operating regime alpha1/alpha2 are already in (1e-5, 1-1e-5)
    and the precisions are far from the clamp, so the guarded run matches
    the unguarded one."""
    aligns = {}
    for name, extra in [("plain", []),
                        ("guarded", ["--clip-alpha1", "1", "--clip-alpha2",
                                     "1", "--gam-clamp", "1e8"])]:
        out = tmp_path / name
        rc = cli_main.main([
            "--ld-files", str(sim_dir / "sim_R.npy"),
            "--r-files", str(sim_dir / "sim_r.npy"),
            "--true-signal-file", str(sim_dir / "sim_bet.npy"),
            "--out-dir", str(out), "--out-name", "t",
            "--N", "1500", "--M", "200", "--iterations", "5",
            "--s", "0.1", "--platform", "cpu", "--x64", "1", "--seed", "7",
        ] + extra)
        assert rc == 0
        aligns[name] = float(_read_csv(out / "t_metrics.csv")[-1][1])
    assert aligns["guarded"] == pytest.approx(aligns["plain"], abs=1e-12)
    assert aligns["guarded"] > 0.9


def test_cli_multi_cohort(tmp_path):
    d = tmp_path / "simk"
    d.mkdir()
    rc = cli_sim.main([
        "gen-phen-mult", "--out", str(d / "mc"), "--N", "1000", "--M", "150",
        "--h2", "0.8", "--lam", "0.1", "--K", "2", "--seed", "1",
    ])
    assert rc == 0
    out = tmp_path / "out"
    rc = cli_main.main([
        "--ld-files", f"{d}/mc_0_R.npy,{d}/mc_1_R.npy",
        "--r-files", f"{d}/mc_0_r.npy,{d}/mc_1_r.npy",
        "--true-signal-file", str(d / "mc_bet.npy"),
        "--out-dir", str(out), "--out-name", "t",
        "--N", "1000,1000", "--M", "150,150", "--K", "2",
        "--iterations", "4", "--s", "0.1", "--platform", "cpu", "--x64", "1",
    ])
    assert rc == 0
    assert (out / "t_cohort_1.csv").exists() and (out / "t_cohort_2.csv").exists()
    assert (out / "t_r1_cohort_2_it_3.bin").exists()
    final_align = float(_read_csv(out / "t_metrics.csv")[-1][1])
    assert final_align > 0.85


def test_cli_checkpoint_resume(sim_dir, tmp_path):
    """5 iterations straight == 2 iterations + resume for 3 more."""
    common = [
        "--ld-files", str(sim_dir / "sim_R.npy"),
        "--r-files", str(sim_dir / "sim_r.npy"),
        "--out-dir", None, "--out-name", "t",
        "--N", "1500", "--M", "200", "--s", "0.1",
        "--platform", "cpu", "--x64", "1", "--seed", "3",
    ]
    outA = tmp_path / "A"
    argsA = [a if a is not None else str(outA) for a in common]
    rc = cli_main.main(argsA + ["--iterations", "5"])
    assert rc == 0

    outB = tmp_path / "B"
    ck = tmp_path / "ck"
    argsB = [a if a is not None else str(outB) for a in common]
    rc = cli_main.main(argsB + ["--iterations", "2", "--checkpoint-dir", str(ck)])
    assert rc == 0
    rc = cli_main.main(argsB + ["--iterations", "5", "--checkpoint-dir", str(ck),
                                "--resume", "1"])
    assert rc == 0
    a = np.fromfile(outA / "t_xhat_it_4.bin", dtype="<f8")
    b = np.fromfile(outB / "t_xhat_it_4.bin", dtype="<f8")
    # Hutchinson probes are drawn from a PRNG key carried in the state, so
    # the resumed run continues the exact same randomness.
    np.testing.assert_allclose(b, a, rtol=1e-10)
    rowsB = _read_csv(outB / "t_cohort_1.csv")
    assert [r[0] for r in rowsB[1:]] == ["0", "1", "2", "3", "4"]


def test_cli_fused_checkpoint_resume(sim_dir, tmp_path):
    """--fused 1 with --checkpoint-dir runs chunked scans (checkpoint +
    output flush between chunks) and resumes the exact trajectory: 5 fused
    iterations straight == 2 + resume for 3 more, all fused."""
    common = [
        "--ld-files", str(sim_dir / "sim_R.npy"),
        "--r-files", str(sim_dir / "sim_r.npy"),
        "--out-dir", None, "--out-name", "t",
        "--N", "1500", "--M", "200", "--s", "0.1",
        "--platform", "cpu", "--x64", "1", "--seed", "3", "--fused", "1",
    ]
    outA = tmp_path / "A"
    argsA = [a if a is not None else str(outA) for a in common]
    rc = cli_main.main(argsA + ["--iterations", "5"])
    assert rc == 0

    outB = tmp_path / "B"
    ck = tmp_path / "ck"
    argsB = [a if a is not None else str(outB) for a in common]
    rc = cli_main.main(argsB + ["--iterations", "2", "--checkpoint-dir",
                                str(ck), "--checkpoint-every", "2"])
    assert rc == 0
    assert (outB / "t_xhat_it_1.bin").exists()  # flushed at the chunk break
    rc = cli_main.main(argsB + ["--iterations", "5", "--checkpoint-dir",
                                str(ck), "--checkpoint-every", "2",
                                "--resume", "1"])
    assert rc == 0
    a = np.fromfile(outA / "t_xhat_it_4.bin", dtype="<f8")
    b = np.fromfile(outB / "t_xhat_it_4.bin", dtype="<f8")
    np.testing.assert_allclose(b, a, rtol=1e-10)
    rowsB = _read_csv(outB / "t_cohort_1.csv")
    assert [r[0] for r in rowsB[1:]] == ["0", "1", "2", "3", "4"]


def test_cli_int8_requires_sym(sim_dir, tmp_path):
    """--ld-dtype int8 on any non-sym operator must be rejected up front:
    casting correlations in [-1, 1] to int8 truncates them all to zero."""
    for op in ["dense", "banded", "blocksparse"]:
        with pytest.raises(SystemExit, match="int8 requires --operator sym"):
            cli_main.main([
                "--ld-files", str(sim_dir / "sim_R.npy"),
                "--r-files", str(sim_dir / "sim_r.npy"),
                "--out-dir", str(tmp_path / op), "--out-name", "t",
                "--N", "1500", "--M", "200", "--iterations", "2",
                "--platform", "cpu", "--operator", op,
                "--ld-dtype", "int8",
            ])


def test_cli_plots_and_visld(sim_dir, tmp_path):
    out = tmp_path / "out"
    cli_main.main([
        "--ld-files", str(sim_dir / "sim_R.npy"),
        "--r-files", str(sim_dir / "sim_r.npy"),
        "--true-signal-file", str(sim_dir / "sim_bet.npy"),
        "--out-dir", str(out), "--out-name", "t",
        "--N", "1500", "--M", "200", "--iterations", "3",
        "--s", "0.1", "--platform", "cpu", "--x64", "1",
    ])
    rc = cli_plots.main([
        "--csv-params", str(out / "t_cohort_1.csv"),
        "--csv-metrics", str(out / "t_metrics.csv"),
        "--out-name", "fig",
    ])
    assert rc == 0 and (out / "fig.png").exists()

    rc = cli_vis.main([
        "--ld-file", str(sim_dir / "sim_R.npy"), "--ld-format", "npy",
        "--out-dir", str(tmp_path),
    ])
    assert rc == 0 and (tmp_path / "sim_R.png").exists()


def test_cli_errors():
    with pytest.raises(SystemExit, match="not equal to number of LD"):
        cli_main.main([
            "--ld-files", "a.npy,b.npy", "--r-files", "a.npy",
            "--N", "10", "--M", "5", "--K", "1",
        ])
    with pytest.raises(SystemExit, match="must be L"):
        cli_main.main([
            "--ld-files", "a.npy", "--r-files", "a.npy",
            "--N", "10", "--M", "5", "--K", "1", "--L", "3",
        ])
