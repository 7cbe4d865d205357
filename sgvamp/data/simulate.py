"""Simulators: behavioral ports of the reference's three data generators.

Each reproduces the corresponding reference script's *distributional
behavior* (documented quirks and all, SURVEY quirks ledger #8), with an
explicit numpy Generator instead of global RNG state:

  simulate_single     ~ simulation/sim_gen_phen.py:28-55
      beta var 1/cm, noise sd sqrt(1/h2 - 1), y standardized, saves R.
  simulate_multi      ~ simulation/sim_gen_phen_mult.py:28-61
      shared beta var h2/cm, per-cohort X, noise sd sqrt(1 - h2),
      y NOT standardized (reference leaves :51 commented out), per-cohort R.
  simulate_from_bed   ~ simulation/sim_phen.py:29-63
      phenotype over real PLINK .bed genotypes (bed_reader gated),
      beta var h2/cm, noise sd sqrt(1 - h2), r only (no R).
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional

import numpy as np


@dataclasses.dataclass
class SimData:
    y: np.ndarray              # (N,) or per-cohort list
    beta: np.ndarray           # (M,)
    r: np.ndarray              # (M,)
    R: Optional[np.ndarray]    # (M, M) or None


def _standardize_genotypes(X: np.ndarray) -> np.ndarray:
    return (X - X.mean(axis=0)) / X.std(axis=0)


def _sparse_beta(rng: np.random.Generator, M: int, lam: float, var: float) -> np.ndarray:
    cm = int(M * lam)
    beta = np.zeros(M)
    idx = rng.choice(M, size=cm, replace=False)
    beta[idx] = rng.normal(0.0, np.sqrt(var), size=cm)
    return beta


def simulate_single(
    N: int, M: int, h2: float = 0.8, lam: float = 0.5,
    rng: Optional[np.random.Generator] = None,
) -> SimData:
    """Single-cohort generator (reference sim_gen_phen.py behavior)."""
    rng = rng or np.random.default_rng()
    X = rng.binomial(2, 0.4, size=(N, M)).astype(np.float64)
    X = _standardize_genotypes(X)
    beta = _sparse_beta(rng, M, lam, var=1.0 / int(M * lam))
    g = X @ beta
    w = rng.normal(0.0, np.sqrt(1.0 / h2 - 1.0), size=N)
    y = g + w
    y = (y - y.mean()) / y.std()
    X /= np.sqrt(N)
    return SimData(y=y, beta=beta, r=X.T @ y, R=X.T @ X)


def simulate_multi(
    N: int, M: int, K: int = 2, h2: float = 0.8, lam: float = 0.5,
    rng: Optional[np.random.Generator] = None,
) -> List[SimData]:
    """Multi-cohort generator (reference sim_gen_phen_mult.py behavior):
    one shared beta, fresh genotypes per cohort, unstandardized y."""
    rng = rng or np.random.default_rng()
    beta = _sparse_beta(rng, M, lam, var=h2 / int(M * lam))
    out = []
    for _ in range(K):
        X = rng.binomial(2, 0.4, size=(N, M)).astype(np.float64)
        X = _standardize_genotypes(X)
        y = X @ beta + rng.normal(0.0, np.sqrt(1.0 - h2), size=N)
        X /= np.sqrt(N)
        out.append(SimData(y=y, beta=beta, r=X.T @ y, R=X.T @ X))
    return out


def simulate_from_bed(
    bed_path: str, M: int, h2: float = 0.8, lam: float = 0.5,
    rng: Optional[np.random.Generator] = None,
) -> SimData:
    """Phenotype simulation over real genotypes (reference sim_phen.py).

    Prefers the optional bed_reader dependency (the reference hard-imports
    it, simulation/sim_phen.py:5); falls back to the vendored PLINK1
    reader (data/bed.py — same A1-count orientation) so the path works
    without extra installs.
    """
    try:
        from bed_reader import open_bed
        X = open_bed(bed_path).read()
    except ImportError:
        from sgvamp.data.bed import read_bed
        X = read_bed(bed_path)
    rng = rng or np.random.default_rng()
    N = X.shape[0]
    X = _standardize_genotypes(X)
    beta = _sparse_beta(rng, M, lam, var=h2 / int(M * lam))
    y = X @ beta + rng.normal(0.0, np.sqrt(1.0 - h2), size=N)
    X /= np.sqrt(N)
    return SimData(y=y, beta=beta, r=X.T @ y, R=None)


def simulate_banded(
    N: int, M: int, bandwidth: int, h2: float = 0.8, lam: float = 0.1,
    K: int = 1, rng: Optional[np.random.Generator] = None,
    dtype=np.float32,
):
    """Small-M dense wrapper around band-storage simulation (tests)."""
    band, r, x0 = simulate_ld_band(N, M, bandwidth, h2, lam, rng=rng, dtype=dtype)
    R = band_to_dense(band)
    Rs = np.repeat(R[None], K, axis=0)
    rs = np.repeat(r[None], K, axis=0)
    return Rs, rs, x0


def simulate_ld_band(
    N: int, M: int, bandwidth: int, h2: float = 0.8, lam: float = 0.1,
    rng: Optional[np.random.Generator] = None, dtype=np.float32,
    strength: float = 0.6, decay: float = 0.85, n_r: int = 1,
):
    """Large-M banded SPD LD panel in band storage - never materializes MxM.

    Construction: a banded lower factor L (positive diagonal, decaying
    band) gives R = L L^T, SPD and banded with twice L's bandwidth; the
    diagonal is then normalized to 1 (a correlation matrix, like X^T X
    with standardized X/sqrt(N), reference sim_gen_phen.py:48-50).

    `strength`/`decay` control L's off-diagonal mass, i.e. how strongly
    correlated (and ill-conditioned) the panel is. The defaults give a
    mildly-correlated panel where CG at rtol=1e-5 needs only a handful of
    iterations; strength ~4 with decay ~0.97 produces the near-singular
    local correlation structure of dense genotyping panels (plain CG
    ~60-80 iterations at rtol=1e-5 - the regime the reference's
    cg_maxit=500 default anticipates, src/main.py:41).

    Returns (band, r, x0) where
      band: (M, 2*bandwidth+1) symmetric band storage,
            band[i, bandwidth + d] = R[i, i+d] for |d| <= bandwidth;
      r = R x0 + eps with eps ~ N(0, (1-h2) R) - the correlated noise the
          summary-statistics likelihood implies (r = X^T y = R x0 + X^T w
          has Var(X^T w) = sigma_w^2 R), drawn as eps = sqrt(1-h2) L w
          using the banded factor R = L L^T;
      x0 = sqrt(N) * beta, beta sparse with slab variance h2/cm - so prior
          vars (0, h2/cm) are the matched hyperparameters.

    This is the scale regime the reference cannot reach (it replicates the
    dense/CSR R per rank, src/main.py:257).
    """
    rng = rng or np.random.default_rng()
    hb = bandwidth // 2  # L bandwidth; R gets 2*hb = bandwidth
    # L band storage, diagonal-major so every diagonal is contiguous:
    # LbT[d, i] = L[i, i-d], d = 0..hb
    prof = (decay ** np.arange(1, hb + 1) * strength / np.sqrt(hb)).astype(np.float64)
    LbT = np.empty((hb + 1, M), dtype=np.float64)
    LbT[0] = 1.0
    LbT[1:] = (rng.uniform(-1.0, 1.0, size=(M, hb)) * prof[None, :]).T
    for d in range(1, hb + 1):  # zero out-of-range entries (row i < d)
        LbT[d, :d] = 0.0
    # R[i, i+k] = sum_d L[i, i-d] * L[i+k, i-d] = sum_d Lb[i, d] * Lb[i+k, d+k]
    upperT = np.zeros((bandwidth + 1, M), dtype=np.float64)
    for k in range(0, bandwidth + 1):
        acc = upperT[k]
        for d in range(0, hb - k + 1):
            # valid rows: i + k < M
            acc[: M - k] += LbT[d, : M - k] * LbT[d + k, k:]
    # Normalize to unit diagonal.
    scale = 1.0 / np.sqrt(upperT[0])
    for k in range(0, bandwidth + 1):
        upperT[k, : M - k] *= scale[: M - k] * scale[k:] if k else scale * scale
    # Symmetric band storage (2*bandwidth+1 diagonals), built diagonal-major.
    bandT = np.zeros((2 * bandwidth + 1, M), dtype=dtype)
    bandT[bandwidth:] = upperT
    for k in range(1, bandwidth + 1):
        bandT[bandwidth - k, k:] = upperT[k, : M - k]
    band = np.ascontiguousarray(bandT.T)

    cm = max(int(M * lam), 1)
    beta = _sparse_beta(rng, M, lam, var=h2 / cm)
    x0 = (np.sqrt(N) * beta).astype(np.float64)
    # eps = sqrt(1-h2) * Lhat @ w with Lhat = diag(scale) L, so that
    # Rhat = Lhat Lhat^T and Var(eps) = (1-h2) Rhat.
    # n_r > 1 draws that many INDEPENDENT noise vectors over the shared
    # panel and signal - K cohorts of a genuine meta-analysis (identical
    # replication instead makes the meta denoiser overconfident by K and
    # destabilizes the EM prior: measured lam 0.01 -> 0.91 in 3 iterations
    # on a K=8 replicated run).
    W = rng.normal(0.0, 1.0, (n_r, M))
    LW = np.zeros((n_r, M))
    for d in range(0, hb + 1):
        if d:
            LW[:, d:] += LbT[d, d:] * W[:, : M - d]
        else:
            LW += LbT[0] * W
    eps = np.sqrt(1.0 - h2) * scale * LW
    r = (_band_matvec_T(bandT, x0)[None, :] + eps).astype(dtype)
    return band, (r[0] if n_r == 1 else r), x0


def band_matvec(band: np.ndarray, x: np.ndarray) -> np.ndarray:
    """y = R @ x with R in symmetric band storage (host-side, for sim/tests)."""
    return _band_matvec_T(np.ascontiguousarray(band.T), x)


def _band_matvec_T(bandT: np.ndarray, x: np.ndarray) -> np.ndarray:
    """band_matvec over diagonal-major storage bandT = band.T (contiguous
    diagonals: one streaming pass each instead of a strided column walk)."""
    nd, M = bandT.shape
    bw = (nd - 1) // 2
    y = bandT[bw] * x
    for k in range(1, bw + 1):
        y[: M - k] += bandT[bw + k, : M - k] * x[k:]
        y[k:] += bandT[bw - k, k:] * x[: M - k]
    return y


def band_to_dense(band: np.ndarray) -> np.ndarray:
    """Materialize band storage to dense (M, M) - small M only (tests)."""
    M, nd = band.shape
    bw = (nd - 1) // 2
    R = np.zeros((M, M), dtype=band.dtype)
    for d in range(-bw, bw + 1):
        idx = np.arange(max(0, -d), min(M, M - d))
        R[idx, idx + d] = band[idx, bw + d]
    return R
