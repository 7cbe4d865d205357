"""End-to-end CLI tests for the PLINK .ld + .bim ingestion path: SNP
harmonization across cohorts with different variant panels, missing-SNP
fill from source cohorts (the reference's MPI-exchange path, src/main.py:
211-249), and the band-direct biobank-scale ingestion."""

import csv

import numpy as np
import pandas as pd
import pytest

from sgvamp.cli import main as cli_main
from sgvamp.cli import simulate as cli_sim


def _make_cohort_data(tmp_path, tag, variants, coords, R_local, r_local):
    """Write .bim, .ld (upper-triangle triplets), and local-order r .npy."""
    bim = tmp_path / f"{tag}.bim"
    with open(bim, "w") as f:
        for rs_, c in zip(variants, coords):
            f.write(f"1\t{rs_}\t0\t{c}\tA\tG\n")
    rows, cols, vals = [], [], []
    Ml = len(variants)
    for i in range(Ml):
        for j in range(i + 1, Ml):
            if R_local[i, j] != 0.0:
                rows.append(i)
                cols.append(j)
                vals.append(R_local[i, j])
    df = pd.DataFrame({
        "CHR_A": 1, "BP_A": [coords[i] for i in rows],
        "SNP_A": [variants[i] for i in rows],
        "CHR_B": 1, "BP_B": [coords[j] for j in cols],
        "SNP_B": [variants[j] for j in cols],
        "R": vals,
    })
    ld = tmp_path / f"{tag}.ld"
    df.to_csv(ld, sep="\t", index=False)
    rnpy = tmp_path / f"{tag}_r.npy"
    np.save(rnpy, r_local)
    return str(bim), str(ld), str(rnpy)


@pytest.fixture(scope="module")
def two_cohorts(tmp_path_factory):
    """Two cohorts over overlapping variant panels with consistent LD."""
    d = tmp_path_factory.mktemp("ldcohorts")
    rng = np.random.default_rng(0)
    M = 40
    variants = [f"rs{i}" for i in range(M)]
    coords = [10 * (i + 1) for i in range(M)]
    # Shared "true" LD: banded correlation built from genotypes.
    N = 4000
    X = rng.binomial(2, 0.4, size=(N, M)).astype(np.float64)
    X = (X - X.mean(0)) / X.std(0)
    beta = np.zeros(M)
    idx = rng.choice(M, 6, replace=False)
    beta[idx] = rng.normal(0, 0.4, 6)
    y = X @ beta + rng.normal(0, 0.5, N)
    Xn = X / np.sqrt(N)
    R = Xn.T @ Xn
    r_ref = Xn.T @ y
    R_sp = np.where(np.abs(R) > 0.02, R, 0.0)  # sparsify off-band noise

    # cohort 0: first 30 variants; cohort 1: last 30 (overlap 20)
    i0 = list(range(30))
    i1 = list(range(10, 40))
    data = {}
    for tag, sel in [("c0", i0), ("c1", i1)]:
        data[tag] = _make_cohort_data(
            d, tag, [variants[i] for i in sel], [coords[i] for i in sel],
            R_sp[np.ix_(sel, sel)], r_ref[sel],
        )
    np.save(d / "beta.npy", (beta / np.sqrt(N)).reshape(M, 1))
    return d, data, M


@pytest.mark.parametrize("operator", ["dense", "banded"])
def test_ld_bim_multicohort_end_to_end(two_cohorts, tmp_path, operator):
    d, data, M = two_cohorts
    out = tmp_path / operator
    rc = cli_main.main([
        "--ld-files", f"{data['c0'][1]},{data['c1'][1]}",
        "--r-files", f"{data['c0'][2]},{data['c1'][2]}",
        "--bim-files", f"{data['c0'][0]},{data['c1'][0]}",
        "--true-signal-file", str(d / "beta.npy"),
        "--out-dir", str(out), "--out-name", "t",
        "--N", "4000,4000", "--M", "30,30", "--K", "2",
        "--iterations", "4", "--s", "0.2", "--platform", "cpu", "--x64", "1",
        "--operator", operator, "--block-size", "8", "--seed", "11",
    ])
    assert rc == 0
    # merged bim written with all 40 variants
    with open(out / "t.bim") as f:
        assert len(f.readlines()) == M
    rows = list(csv.reader(open(out / "t_metrics.csv"), delimiter="\t"))
    assert len(rows) == 5
    xh = np.fromfile(out / "t_xhat_it_3.bin", dtype="<f8")
    assert xh.shape == (M,) and np.all(np.isfinite(xh))


def test_ld_dense_and_banded_agree(two_cohorts, tmp_path):
    """The band-direct ingestion must reproduce the dense/CSR ingestion
    when the bandwidth captures every entry (and no duplicate triplets)."""
    d, data, M = two_cohorts
    outs = {}
    for operator in ["dense", "banded"]:
        out = tmp_path / f"agree_{operator}"
        cli_main.main([
            "--ld-files", f"{data['c0'][1]},{data['c1'][1]}",
            "--r-files", f"{data['c0'][2]},{data['c1'][2]}",
            "--bim-files", f"{data['c0'][0]},{data['c1'][0]}",
            "--out-dir", str(out), "--out-name", "t",
            "--N", "4000,4000", "--M", "30,30", "--K", "2",
            "--iterations", "3", "--s", "0.2", "--platform", "cpu", "--x64", "1",
            "--operator", operator, "--block-size", "8", "--seed", "5",
        ])
        outs[operator] = np.fromfile(out / "t_xhat_it_2.bin", dtype="<f8")
    np.testing.assert_allclose(outs["banded"], outs["dense"],
                               rtol=1e-8, atol=1e-12)


def test_cli_gen_band_roundtrip(tmp_path):
    """gen-band (biobank-scale generator) writes CLI-ingestible files:
    sparse CSR .npz + r + bet, with the printed matched prior; the driver
    ingests them band-direct and recovers the signal."""
    import csv

    from sgvamp.cli import main as cli_main
    from sgvamp.cli import simulate as cli_sim

    out = tmp_path / "t"
    rc = cli_sim.main([
        "gen-band", "--out", str(out), "--N", "20000", "--M", "2048",
        "--h2", "0.7", "--lam", "0.01", "--bandwidth", "64", "--seed", "0"])
    assert rc == 0
    rundir = tmp_path / "run"
    rc = cli_main.main([
        "--ld-files", str(out) + "_R.npz", "--r-files", str(out) + "_r.npy",
        "--true-signal-file", str(out) + "_bet.npy",
        "--out-dir", str(rundir), "--out-name", "b",
        "--N", "20000", "--M", "2048", "--iterations", "5",
        "--platform", "cpu", "--x64", "0", "--dtype", "float32",
        "--operator", "sym", "--block-size", "128",
        "--prior-probs", "0.99,0.01", "--prior-vars", "0,0.034146",
        "--lmmse-damp", "1", "--stop-on-divergence", "1"])
    assert rc == 0
    with open(rundir / "b_metrics.csv") as f:
        rows = list(csv.reader(f, delimiter="\t"))[1:]
    best_align = max(float(r[1]) for r in rows)
    assert best_align > 0.99


def test_shared_panel_path_dedupe(tmp_path):
    """Shared-panel meta-analysis: listing the SAME .npz once per cohort
    must produce outputs identical to listing per-cohort COPIES of the
    file - the deduped load/convert/pack path changes cost, not results
    (7/8 of the K=8 x M=1M ingestion wall was redundant conversions)."""
    import shutil

    out = tmp_path / "p"
    rc = cli_sim.main([
        "gen-band", "--out", str(out), "--N", "20000", "--M", "1024",
        "--h2", "0.7", "--lam", "0.02", "--bandwidth", "64", "--seed", "3",
        "--K", "2"])
    assert rc == 0
    R = str(out) + "_R.npz"
    R2 = str(tmp_path / "copy_R.npz")
    shutil.copy(R, R2)
    rfiles = f"{out}_0_r.npy,{out}_1_r.npy"
    results = {}
    for name, ld in [("shared", f"{R},{R}"), ("copies", f"{R},{R2}")]:
        rundir = tmp_path / name
        rc = cli_main.main([
            "--ld-files", ld, "--r-files", rfiles,
            "--out-dir", str(rundir), "--out-name", "t",
            "--N", "20000,20000", "--M", "1024", "--K", "2",
            "--iterations", "3", "--platform", "cpu", "--x64", "0",
            "--dtype", "float32", "--operator", "sym",
            "--block-size", "128", "--ld-dtype", "int8", "--seed", "5"])
        assert rc == 0
        results[name] = (rundir / "t_xhat_it_2.bin").read_bytes()
    assert results["shared"] == results["copies"]
