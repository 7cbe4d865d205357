"""PLINK1 .bed path: the vendored reader/writer (data/bed.py) and the
real-genotype phenotype simulator's math (simulate_from_bed ~ reference
simulation/sim_phen.py:29-63), executed against a numpy oracle — not just
the dependency gate."""

import numpy as np
import pytest

from sgvamp.data.bed import MAGIC, read_bed, write_bed
from sgvamp.data.simulate import simulate_from_bed


def _random_genotypes(rng, N, M, missing=0.0):
    G = rng.binomial(2, 0.4, size=(N, M)).astype(np.float64)
    if missing:
        G[rng.random(size=G.shape) < missing] = np.nan
    return G


@pytest.mark.parametrize("N,M", [(40, 17), (41, 8), (7, 3), (4, 1)])
def test_bed_round_trip(tmp_path, N, M):
    """write_bed -> read_bed is the identity on {0,1,2} counts, including
    the N % 4 != 0 padding tail."""
    rng = np.random.default_rng(0)
    G = _random_genotypes(rng, N, M)
    p = str(tmp_path / "t.bed")
    write_bed(p, G)
    got = read_bed(p)
    np.testing.assert_array_equal(got, G)
    # extension-less path works too (PLINK convention)
    np.testing.assert_array_equal(read_bed(p[:-4]), G)


def test_bed_missing_codes_round_trip(tmp_path):
    """Missing genotypes (code 01) survive as NaN, matching bed_reader."""
    rng = np.random.default_rng(1)
    G = _random_genotypes(rng, 30, 5, missing=0.1)
    assert np.isnan(G).any()
    p = str(tmp_path / "m.bed")
    write_bed(p, G)
    got = read_bed(p)
    np.testing.assert_array_equal(np.isnan(got), np.isnan(G))
    np.testing.assert_array_equal(got[~np.isnan(G)], G[~np.isnan(G)])


def test_bed_byte_layout_is_plink1():
    """Lock the exact on-disk encoding to the PLINK1 spec: magic bytes,
    SNP-major, sample i at bits 2*(i%4), codes 00=2 A1, 10=het, 11=0 A1."""
    import tempfile

    G = np.asarray([[2.0], [1.0], [0.0], [2.0], [1.0]])  # N=5, M=1
    with tempfile.TemporaryDirectory() as d:
        p = d + "/x.bed"
        write_bed(p, G)
        raw = open(p, "rb").read()
    assert raw[:3] == MAGIC
    # byte 0: samples 0..3 = codes 00,10,11,00 -> 0b00_11_10_00 = 0x38
    assert raw[3] == 0b00111000
    # byte 1: sample 4 = code 10, padding zeros -> 0b000000_10
    assert raw[4] == 0b00000010
    assert len(raw) == 3 + 2


def test_bed_error_paths(tmp_path):
    p = str(tmp_path / "bad.bed")
    with open(p, "wb") as f:
        f.write(b"\x00\x00\x00")
    with pytest.raises(FileNotFoundError, match=".fam"):
        read_bed(p)  # no companions
    write_bed(str(tmp_path / "ok.bed"), np.zeros((4, 2)) + 2.0)
    import shutil

    shutil.copy(str(tmp_path / "ok.fam"), str(tmp_path / "bad.fam"))
    shutil.copy(str(tmp_path / "ok.bim"), str(tmp_path / "bad.bim"))
    with pytest.raises(ValueError, match="bad magic"):
        read_bed(p)
    # truncated body
    with open(str(tmp_path / "ok.bed"), "ab") as f:
        f.write(b"\x00")
    with pytest.raises(ValueError, match="genotype bytes"):
        read_bed(str(tmp_path / "ok.bed"))


def test_simulate_from_bed_math_matches_oracle(tmp_path):
    """The r / beta math of the .bed simulator against a direct numpy
    oracle on the same genotypes and PRNG stream (reference
    sim_phen.py:37-63: standardize X, beta var h2/cm, noise sd
    sqrt(1-h2), X /= sqrt(N), r = X^T y)."""
    rng = np.random.default_rng(3)
    N, M, h2, lam = 60, 24, 0.8, 0.25
    G = _random_genotypes(rng, N, M)
    p = str(tmp_path / "sim.bed")
    write_bed(p, G)

    sim = simulate_from_bed(p, M=M, h2=h2, lam=lam,
                            rng=np.random.default_rng(7))

    # oracle: same draws in the same order from an identical generator
    oracle_rng = np.random.default_rng(7)
    X = (G - G.mean(axis=0)) / G.std(axis=0)
    cm = int(M * lam)
    beta = np.zeros(M)
    idx = oracle_rng.choice(M, size=cm, replace=False)
    beta[idx] = oracle_rng.normal(0.0, np.sqrt(h2 / cm), size=cm)
    y = X @ beta + oracle_rng.normal(0.0, np.sqrt(1.0 - h2), size=N)
    X = X / np.sqrt(N)
    r = X.T @ y

    np.testing.assert_allclose(sim.beta, beta, rtol=1e-12)
    np.testing.assert_allclose(sim.y, y, rtol=1e-12)
    np.testing.assert_allclose(sim.r, r, rtol=1e-12)
    assert sim.R is None  # sim_phen.py saves r but no R (:61-63)
    assert np.count_nonzero(sim.beta) == cm


def test_simulate_from_bed_feeds_engine(tmp_path):
    """End-to-end: .bed genotypes -> simulate_from_bed -> VAMP recovers
    the signal (R computed from the same standardized X)."""
    import jax.numpy as jnp

    from sgvamp import PriorState, VampConfig, VampEngine, VampInputs
    from sgvamp.core.operators import DenseLD

    rng = np.random.default_rng(5)
    N, M, h2, lam = 2000, 64, 0.8, 0.25
    G = _random_genotypes(rng, N, M)
    p = str(tmp_path / "e2e.bed")
    write_bed(p, G)
    sim = simulate_from_bed(p, M=M, h2=h2, lam=lam,
                            rng=np.random.default_rng(11))
    X = (G - G.mean(axis=0)) / G.std(axis=0) / np.sqrt(N)
    R = X.T @ X
    cfg = VampConfig(prior_update="em", dtype="float64", cg_maxit=200,
                     cg_rtol=1e-10)
    cm = int(M * lam)
    prior = PriorState.create(lam, [1.0], [h2 / cm * N])
    inputs = VampInputs(op=DenseLD(mats=jnp.asarray(R)[None], s=0.05),
                        r=jnp.asarray(sim.r)[None], a=jnp.asarray([1.0]),
                        N=jnp.asarray([float(N)]))
    hist = VampEngine(inputs, cfg, prior).run(8, x0=sim.beta * np.sqrt(N))
    assert max(hist["alignment"]) > 0.9


def test_cli_phen_subcommand(tmp_path):
    """`simulate phen` (reference sim_phen.py's CLI role) runs on the
    vendored reader and writes the reference's file set: _phen/_bet/_r,
    no _R (sim_phen.py:61-63)."""
    from sgvamp.cli import simulate as cli_sim

    rng = np.random.default_rng(2)
    G = _random_genotypes(rng, 50, 16)
    write_bed(str(tmp_path / "g.bed"), G)
    out = str(tmp_path / "o")
    rc = cli_sim.main(["phen", "--out", out, "--bed",
                       str(tmp_path / "g.bed"), "--M", "16",
                       "--h2", "0.7", "--lam", "0.25", "--seed", "4"])
    assert rc == 0
    assert np.load(out + "_phen.npy").shape == (50,)
    assert np.load(out + "_bet.npy").shape == (16, 1)
    assert np.load(out + "_r.npy").shape == (16,)
    import os
    assert not os.path.exists(out + "_R.npy")
