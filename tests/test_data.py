"""Data-layer tests: loaders for every reference format, .bim harmonization
with missing-SNP source assignment, cross-cohort fill, PLINK converters."""

import os
import struct

import numpy as np
import pandas as pd
import pytest
import scipy.sparse

from sgvamp.data import harmonize as hz
from sgvamp.data import loaders
from sgvamp.data.plink import ld_to_npz, linear_to_npy
from sgvamp.data.simulate import simulate_multi, simulate_single


def _write_bim(path, variants, coords):
    with open(path, "w") as f:
        for rs, c in zip(variants, coords):
            f.write(f"1\t{rs}\t0\t{c}\tA\tG\n")


# ---------------------------------------------------------------------------
# r loaders
# ---------------------------------------------------------------------------

def test_load_r_formats(tmp_path):
    r = np.random.default_rng(0).normal(size=8)
    np.save(tmp_path / "r.npy", r)
    np.savetxt(tmp_path / "r.txt", r)
    np.testing.assert_allclose(loaders.load_r(str(tmp_path / "r.npy"), 8, 100), r)
    np.testing.assert_allclose(loaders.load_r(str(tmp_path / "r.txt"), 8, 100), r)

    # .linear: BETA column, NaN -> 0, scaled by sqrt(N) (main.py:181-185)
    df = pd.DataFrame({
        "CHR": 1, "SNP": [f"rs{i}" for i in range(8)], "BP": range(8),
        "A1": "A", "TEST": "ADD", "NMISS": 100,
        "BETA": list(r[:7]) + [np.nan], "STAT": 0.0, "P": 0.5,
    })
    df.to_csv(tmp_path / "r.assoc.linear", sep="\t", index=False)
    got = loaders.load_r(str(tmp_path / "r.assoc.linear"), 8, 100)
    want = np.concatenate([r[:7], [0.0]]) * np.sqrt(100)
    np.testing.assert_allclose(got, want)

    with pytest.raises(ValueError, match="Unsupported r vector"):
        loaders.load_r("r.parquet", 8, 100)


def test_scatter_to_reference():
    r_local = np.asarray([1.0, 2.0, 3.0])
    i_map = np.asarray([2, 0, 4])
    out = loaders.scatter_to_reference(r_local, i_map, 5)
    np.testing.assert_allclose(out, [2.0, 0.0, 1.0, 0.0, 3.0])


# ---------------------------------------------------------------------------
# R loaders
# ---------------------------------------------------------------------------

def test_load_R_formats(tmp_path):
    rng = np.random.default_rng(1)
    M = 6
    R = rng.normal(size=(M, M))
    R = (R + R.T) / 2
    np.save(tmp_path / "R.npy", R)
    np.testing.assert_allclose(loaders.load_R(str(tmp_path / "R.npy")), R)

    Rs = scipy.sparse.csr_matrix(R)
    scipy.sparse.save_npz(tmp_path / "R.npz", Rs)
    got = loaders.load_R(str(tmp_path / "R.npz"))
    np.testing.assert_allclose(got.toarray(), R)

    with pytest.raises(ValueError, match="Unsupported R matrix"):
        loaders.load_R("R.h5")


def test_ld_table_roundtrip(tmp_path):
    """A PLINK .ld table becomes a symmetric unit-diagonal CSR."""
    variants = [f"rs{i}" for i in range(4)]
    vindex = {rs: i for i, rs in enumerate(variants)}
    df = pd.DataFrame({
        "CHR_A": 1, "BP_A": [1, 1, 2], "SNP_A": ["rs0", "rs0", "rs1"],
        "CHR_B": 1, "BP_B": [2, 3, 3], "SNP_B": ["rs1", "rs2", "rs2"],
        "R": [0.5, 0.25, -0.3],
    })
    df.to_csv(tmp_path / "panel.ld", sep="\t", index=False)
    R = loaders.load_R(str(tmp_path / "panel.ld"), vindex).toarray()
    want = np.eye(4)
    want[0, 1] = want[1, 0] = 0.5
    want[0, 2] = want[2, 0] = 0.25
    want[1, 2] = want[2, 1] = -0.3
    np.testing.assert_allclose(R, want)

    with pytest.raises(ValueError, match="requires .bim"):
        loaders.load_R(str(tmp_path / "panel.ld"), None)


# ---------------------------------------------------------------------------
# harmonization
# ---------------------------------------------------------------------------

def test_harmonize_merges_and_assigns_sources(tmp_path):
    # Cohort 0 has rs0..rs3; cohort 1 has rs2..rs5 (bigger N); cohort 2 has
    # rs4, rs5 only. Union = rs0..rs5 ordered by coordinate.
    _write_bim(tmp_path / "c0.bim", ["rs0", "rs1", "rs2", "rs3"], [10, 20, 30, 40])
    _write_bim(tmp_path / "c1.bim", ["rs2", "rs3", "rs4", "rs5"], [30, 40, 50, 60])
    _write_bim(tmp_path / "c2.bim", ["rs4", "rs5"], [50, 60])
    out_bim = tmp_path / "merged.bim"
    panel = hz.harmonize(
        [str(tmp_path / f"c{i}.bim") for i in range(3)],
        N_list=[100, 500, 200],
        out_bim_path=str(out_bim),
    )
    assert panel.M == 6
    assert panel.variants == [f"rs{i}" for i in range(6)]
    assert out_bim.exists()
    # cohort 0 misses rs4, rs5; holder with max N among {1, 2} is 1 (N=500)
    np.testing.assert_array_equal(panel.missing[0], [4, 5])
    assert all(panel.sources[0][[4, 5]] == 1)
    # cohort 2 misses rs0..rs3: rs0, rs1 only held by cohort 0; rs2, rs3 by
    # cohort 1 (larger N than cohort 0)
    np.testing.assert_array_equal(panel.missing[2], [0, 1, 2, 3])
    assert all(panel.sources[2][[0, 1]] == 0)
    assert all(panel.sources[2][[2, 3]] == 1)
    # i_map: cohort 1's local order maps to reference indices 2..5
    np.testing.assert_array_equal(panel.i_maps[1], [2, 3, 4, 5])


def test_fill_missing_from_source():
    rng = np.random.default_rng(2)
    M = 4
    panel = hz.identity_panel(M, 2)
    # cohort 0 misses marker 3, sourced from cohort 1
    panel.missing[0] = np.asarray([3])
    panel.sources[0][3] = 1
    R0 = np.eye(M)
    R1 = rng.normal(size=(M, M))
    R1 = (R1 + R1.T) / 2
    r0, r1 = np.zeros(M), rng.normal(size=M)
    filled, rs = loaders.fill_missing_from_source([R0, R1], [r0, r1], panel)
    np.testing.assert_allclose(filled[0][3, :], R1[3, :])
    np.testing.assert_allclose(filled[0][:, 3], R1[:, 3])
    np.testing.assert_allclose(rs[0][3], r1[3])
    np.testing.assert_allclose(filled[0][:3, :3], np.eye(3))  # rest untouched
    np.testing.assert_allclose(filled[1], R1)


def test_fill_missing_csr_matches_dense_fill():
    """The sparse-level fill (no M x M densification) must reproduce
    fill_missing_from_source exactly, including overwrite semantics on
    row/column intersections across multiple source cohorts."""
    rng = np.random.default_rng(5)
    M, K = 32, 3
    panel = hz.identity_panel(M, K)
    # cohort 0 misses a scattered set, sourced from cohorts 1 AND 2
    miss = np.asarray([3, 7, 20, 31])
    panel.missing[0] = miss
    panel.sources[0][[3, 20]] = 1
    panel.sources[0][[7, 31]] = 2
    Rs_dense, rs = [], []
    for k in range(K):
        A = rng.normal(size=(M, M)) * (rng.random((M, M)) < 0.2)
        A = (A + A.T) / 2
        np.fill_diagonal(A, 1.0)
        Rs_dense.append(A)
        rs.append(rng.normal(size=M))
    want_R, want_r = loaders.fill_missing_from_source(
        [R.copy() for R in Rs_dense], [r.copy() for r in rs], panel)
    got_R, got_r = loaders.fill_missing_csr(
        [scipy.sparse.csr_matrix(R) for R in Rs_dense],
        [r.copy() for r in rs], panel)
    for k in range(K):
        assert scipy.sparse.issparse(got_R[k]), "fill must stay sparse"
        np.testing.assert_allclose(got_R[k].toarray(), np.asarray(want_R[k]),
                                   atol=1e-15)
        np.testing.assert_allclose(got_r[k], want_r[k])


# ---------------------------------------------------------------------------
# true signal
# ---------------------------------------------------------------------------

def test_load_true_signal(tmp_path):
    x = np.random.default_rng(3).normal(size=5)
    np.save(tmp_path / "x.npy", x)
    with open(tmp_path / "x.bin", "wb") as f:
        f.write(struct.pack("5d", *x))
    for name in ["x.npy", "x.bin"]:
        got = loaders.load_true_signal(str(tmp_path / name), 5, 400)
        np.testing.assert_allclose(got, x * 20.0)


# ---------------------------------------------------------------------------
# PLINK converters
# ---------------------------------------------------------------------------

def test_plink_converters(tmp_path):
    rng = np.random.default_rng(4)
    M = 5
    beta = rng.normal(size=M)
    df = pd.DataFrame({
        "CHR": 1, "SNP": [f"rs{i}" for i in range(M)], "BP": range(M),
        "A1": "A", "TEST": "ADD", "NMISS": 50, "BETA": beta,
        "STAT": 0.0, "P": 0.5,
    })
    lin = tmp_path / "gwas.assoc.linear"
    df.to_csv(lin, sep="\t", index=False)
    out_r, r = linear_to_npy(str(lin))
    np.testing.assert_allclose(np.load(out_r), beta)

    ld = pd.DataFrame({
        "CHR_A": 1, "BP_A": [0, 1], "SNP_A": ["rs0", "rs1"],
        "CHR_B": 1, "BP_B": [1, 2], "SNP_B": ["rs1", "rs2"],
        "R": [0.8, -0.2],
    })
    ldf = tmp_path / "gwas.ld"
    ld.to_csv(ldf, sep="\t", index=False)
    out_R = ld_to_npz(str(ldf), str(lin))
    R = scipy.sparse.load_npz(out_R).toarray()
    assert R.shape == (M, M)
    np.testing.assert_allclose(np.diag(R), 1.0)
    np.testing.assert_allclose(R[0, 1], 0.8)
    np.testing.assert_allclose(R[2, 1], -0.2)


# ---------------------------------------------------------------------------
# simulators
# ---------------------------------------------------------------------------

def test_simulate_single_properties():
    rng = np.random.default_rng(5)
    d = simulate_single(3000, 100, h2=0.8, lam=0.2, rng=rng)
    assert d.R.shape == (100, 100)
    # y standardized (reference sim_gen_phen.py:46)
    np.testing.assert_allclose(d.y.std(), 1.0, atol=1e-9)
    np.testing.assert_allclose(d.y.mean(), 0.0, atol=1e-9)
    assert np.count_nonzero(d.beta) == 20
    # R diagonal ~ 1 after the /sqrt(N) normalization
    np.testing.assert_allclose(np.diag(d.R), 1.0, atol=1e-9)


def test_simulate_multi_properties():
    rng = np.random.default_rng(6)
    ds = simulate_multi(3000, 80, K=3, h2=0.5, lam=0.25, rng=rng)
    assert len(ds) == 3
    # shared beta across cohorts (reference sim_gen_phen_mult.py:29-33)
    np.testing.assert_array_equal(ds[0].beta, ds[1].beta)
    # y NOT standardized (reference leaves :51 commented): Var(y) ~ 1 by
    # construction (h2 + (1-h2)) but mean/std not exactly 0/1
    assert abs(ds[0].y.std() - 1.0) > 1e-12


def test_estimate_bandwidth():
    M = 10
    R = np.eye(M)
    R[0, 3] = R[3, 0] = 0.5
    assert loaders.estimate_bandwidth(R) == 3
    assert loaders.estimate_bandwidth(scipy.sparse.csr_matrix(R)) == 3


# ---------------------------------------------------------------------------
# stdlib table readers vs the pandas readers they replace
# ---------------------------------------------------------------------------

def test_linear_reader_matches_pandas(tmp_path):
    from sgvamp.data import tables

    rng = np.random.default_rng(4)
    beta = rng.normal(size=50)
    beta[[3, 17]] = np.nan
    df = pd.DataFrame({"CHR": 1, "SNP": [f"rs{i}" for i in range(50)],
                       "BP": np.arange(50) * 7, "A1": "A", "TEST": "ADD",
                       "NMISS": 100, "BETA": beta, "STAT": 0.0, "P": 0.5})
    path = tmp_path / "g.assoc.linear"
    df.to_csv(path, sep=" ", index=False, na_rep="NA")
    # round_trip: correctly rounded like float(); pandas' default fast
    # parser can land 1 ulp away
    want = pd.read_table(path, sep=r"\s+", float_precision="round_trip")
    got = tables.read_columns(str(path))
    assert list(got) == list(want.columns)
    np.testing.assert_array_equal(tables.to_float(got["BETA"]),
                                  want["BETA"].to_numpy(np.float64))
    assert got["SNP"] == list(want["SNP"])
    r = loaders.load_r(str(path), 50, 400)
    np.testing.assert_array_equal(
        r, np.nan_to_num(want["BETA"].to_numpy(np.float64)) * np.sqrt(400))


def test_ld_table_python_reader_matches_pandas(tmp_path, monkeypatch):
    monkeypatch.setenv("SGVAMP_NO_NATIVE", "1")
    rng = np.random.default_rng(5)
    snps = [f"rs{i}" for i in range(30)]
    a = rng.integers(0, 29, 60)
    b = a + rng.integers(1, 3, 60).clip(max=29 - a)
    ld = pd.DataFrame({"CHR_A": 1, "BP_A": a, "SNP_A": [snps[i] for i in a],
                       "CHR_B": 1, "BP_B": b, "SNP_B": [snps[i] for i in b],
                       "R": rng.uniform(-1, 1, 60)})
    path = tmp_path / "p.ld"
    ld.to_csv(path, sep="\t", index=False)
    want = pd.read_table(path, sep=r"\s+", float_precision="round_trip")
    vindex = {s: i for i, s in enumerate(snps)}
    rows, cols, vals = loaders.load_ld_table(str(path), vindex)
    np.testing.assert_array_equal(rows, [vindex[s] for s in want["SNP_A"]])
    np.testing.assert_array_equal(cols, [vindex[s] for s in want["SNP_B"]])
    np.testing.assert_array_equal(vals, want["R"].to_numpy(np.float64))


def test_harmonize_matches_pandas_outer_merge(tmp_path):
    """Same variant order, index maps and merged .bim rows as the pandas
    outer merge + coordinate sort it replaces."""
    rng = np.random.default_rng(6)
    pool = [f"rs{i}" for i in rng.permutation(300)]
    coord = {v: int(c) for v, c in zip(pool, rng.permutation(300) * 10 + 5)}
    paths = []
    for k in range(3):
        vs = [pool[i] for i in sorted(rng.choice(300, 120, replace=False))]
        paths.append(str(tmp_path / f"c{k}.bim"))
        _write_bim(paths[-1], vs, [coord[v] for v in vs])
    out_bim = tmp_path / "merged.bim"
    panel = hz.harmonize(paths, [100, 300, 200], out_bim_path=str(out_bim))

    bims = [pd.read_table(p, sep=r"\s+", header=None, names=hz.BIM_COLUMNS)
            for p in paths]
    ref = bims[0]
    for k in range(1, 3):
        ref = pd.merge(ref, bims[k], on=["Variant"], how="outer",
                       suffixes=("", "_y"))
        for col in [c for c in hz.BIM_COLUMNS if c != "Variant"]:
            ref[col] = ref[col].fillna(ref[col + "_y"])
        ref = ref[hz.BIM_COLUMNS]
    ref = ref.sort_values(by=["Coordinate"], kind="stable")
    assert panel.variants == list(ref["Variant"])
    idx = {v: i for i, v in enumerate(panel.variants)}
    for k in range(3):
        np.testing.assert_array_equal(panel.i_maps[k],
                                      bims[k]["Variant"].map(idx).to_numpy())
    merged = pd.read_table(out_bim, sep=r"\s+", header=None,
                           names=hz.BIM_COLUMNS)
    assert list(merged["Variant"]) == list(ref["Variant"])
    np.testing.assert_array_equal(merged["Coordinate"].to_numpy(np.float64),
                                  ref["Coordinate"].to_numpy(np.float64))


def test_harmonize_one_cohort_keeps_file_order_on_tied_coordinates(tmp_path):
    """One cohort: its file order, then a stable Coordinate sort. Two
    chromosomes that reuse the same coordinates tie on every marker."""
    rng = np.random.default_rng(7)
    rows = [(chrom, f"rs{chrom}_{i}", c) for chrom in (1, 2)
            for i, c in enumerate(sorted(rng.choice(40, 25, replace=False)))]
    path = tmp_path / "one.bim"
    with open(path, "w") as f:
        for chrom, rs, c in rows:
            f.write(f"{chrom}\t{rs}\t0\t{c}\tA\tG\n")
    panel = hz.harmonize([str(path)], [100])
    want = [rs for _, rs, _ in sorted(rows, key=lambda r: r[2])]  # stable
    assert panel.variants == want
    bim = pd.read_table(path, sep=r"\s+", header=None, names=hz.BIM_COLUMNS)
    assert panel.variants == list(
        bim.sort_values(by=["Coordinate"], kind="stable")["Variant"])
    idx = {v: i for i, v in enumerate(want)}
    np.testing.assert_array_equal(panel.i_maps[0], [idx[rs] for _, rs, _ in rows])
