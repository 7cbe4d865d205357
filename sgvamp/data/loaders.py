"""Host-side loaders for summary statistics: r vectors, LD matrices, true
signals, and the cross-cohort missing-SNP fill.

Format support mirrors the reference loaders exactly:
  r:  .txt (loadtxt), .npy, PLINK .linear (BETA column, NaN->0, *sqrt(N))
      (reference src/main.py:176-194)
  R:  sparse .npz, dense .npy, PLINK .ld table (SNP_A, SNP_B, R ->
      symmetric matrix with unit diagonal) (reference src/main.py:199-263)
  x0: .bin packed doubles or .npy, both *sqrt(N) (reference src/main.py:269-285)

Where the reference exchanges missing-SNP LD rows over MPI point-to-point
(src/main.py:211-249), the single-driver design loads all cohorts and fills
each cohort's missing rows/columns from its assigned source cohort in
memory (fill_missing_from_source).
"""

from __future__ import annotations

import struct
from typing import List, Optional, Sequence, Tuple

import numpy as np
import scipy.sparse

from sgvamp.data import tables
from sgvamp.data.harmonize import HarmonizedPanel


# ---------------------------------------------------------------------------
# r vectors
# ---------------------------------------------------------------------------

def load_r(path: str, M_local: int, N: float) -> np.ndarray:
    """Load a cohort's marginal-association vector in local index space."""
    if path.endswith(".txt"):
        r = np.loadtxt(path).reshape(M_local)
    elif path.endswith(".npy"):
        r = np.load(path).reshape(M_local)
    elif path.endswith(".linear"):
        r = tables.to_float(tables.read_columns(path, ["BETA"])["BETA"]).reshape(M_local)
        r[np.isnan(r)] = 0.0
        r = r * np.sqrt(N)
    else:
        raise ValueError(f"Unsupported r vector format: {path}")
    return np.asarray(r, dtype=np.float64)


def scatter_to_reference(r_local: np.ndarray, i_map: np.ndarray, M: int) -> np.ndarray:
    """Place local-order values into reference index space (src/main.py:190-191)."""
    out = np.zeros(M, dtype=np.float64)
    out[i_map] = r_local
    return out


# ---------------------------------------------------------------------------
# LD matrices
# ---------------------------------------------------------------------------

def load_ld_table(path: str, variant_index: dict) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Parse a PLINK .ld table into (rows, cols, vals) in reference index
    space (reference src/main.py:205-208; scripts/plink2np.py:33-41).

    Uses the native C++ parser (sgvamp.native) when available - one
    streaming pass with a hash-map SNP lookup - and falls back to Python.
    """
    from sgvamp import native

    # variant_index is insertion-ordered (built from the harmonized list).
    got = native.parse_ld(path, list(variant_index.keys()))
    if got is not None:
        return got
    t = tables.read_columns(path, ["SNP_A", "SNP_B", "R"])
    rows = np.asarray([variant_index[rs] for rs in t["SNP_A"]], dtype=np.int64)
    cols = np.asarray([variant_index[rs] for rs in t["SNP_B"]], dtype=np.int64)
    return rows, cols, tables.to_float(t["R"])


def triplets_to_csr(rows, cols, vals, M: int) -> scipy.sparse.csr_matrix:
    """Symmetric CSR with unit diagonal from one-sided LD triplets - the
    shared CSR-assembly idiom (reference src/main.py:251-257 and
    scripts/plink2np.py:42-48; one implementation here per SURVEY 3.4)."""
    ind_r = np.concatenate([np.arange(M), rows, cols])
    ind_c = np.concatenate([np.arange(M), cols, rows])
    v = np.concatenate([np.ones(M), vals, vals])
    return scipy.sparse.csr_matrix((v, (ind_r, ind_c)), shape=(M, M))


def load_R(path: str, variant_index: Optional[dict] = None):
    """Load an LD matrix: returns scipy CSR for .npz/.ld, dense ndarray for .npy."""
    if path.endswith(".npz"):
        return scipy.sparse.load_npz(path)
    if path.endswith(".npy"):
        return np.load(path)
    if path.endswith(".ld"):
        if variant_index is None:
            raise ValueError(".ld input requires .bim files for variant indexing")
        rows, cols, vals = load_ld_table(path, variant_index)
        M = len(variant_index)
        return triplets_to_csr(rows, cols, vals, M)
    raise ValueError(f"Unsupported R matrix format: {path}")


def as_csr(R, M: Optional[int] = None):
    """CSR view of anything load_R returns (sparse matrix or dense .npy)."""
    if scipy.sparse.issparse(R):
        return R.tocsr()
    return scipy.sparse.csr_matrix(np.asarray(R))


def fill_missing_csr(
    Rs: List, rs: List[np.ndarray], panel: HarmonizedPanel
) -> Tuple[List, List[np.ndarray]]:
    """Sparse missing-SNP fill: fill_missing_from_source semantics without
    ever materializing an M x M dense matrix (O(K * nnz) instead of
    O(K * M^2) memory - the fill the large-M paths need).

    For cohort k's missing indices assigned to source cohort j, cohort j's
    LD rows AND columns at those indices replace whatever cohort k had
    there (assignment semantics: later sources overwrite earlier ones on
    row/column intersections, exactly like the dense version's sequential
    row-then-column assignment).
    """
    K = len(Rs)
    out_R, out_r = [], []
    for k in range(K):
        A = as_csr(Rs[k]).tocoo()
        M = A.shape[0]
        row, col, dat = A.row, A.col, A.data
        r_k = np.array(rs[k], copy=True)
        for j in range(K):
            if j == k:
                continue
            take = panel.missing[k][panel.sources[k][panel.missing[k]] == j]
            if take.size == 0:
                continue
            in_take = np.zeros(M, dtype=bool)
            in_take[take] = True
            keep = ~(in_take[row] | in_take[col])
            Bj = as_csr(Rs[j]).tocoo()
            sel = in_take[Bj.row] | in_take[Bj.col]
            row = np.concatenate([row[keep], Bj.row[sel]])
            col = np.concatenate([col[keep], Bj.col[sel]])
            dat = np.concatenate([dat[keep], Bj.data[sel]])
            r_k[take] = np.asarray(rs[j])[take]
        out_R.append(scipy.sparse.csr_matrix((dat, (row, col)), shape=(M, M)))
        out_r.append(r_k)
    return out_R, out_r


def fill_missing_from_source(
    Rs: List, rs: List[np.ndarray], panel: HarmonizedPanel
) -> Tuple[List, List[np.ndarray]]:
    """Fill each cohort's missing reference SNPs from its source cohorts.

    Replaces the reference's MPI send/recv of LD triplets and r values
    (src/main.py:211-249): for cohort k's missing index set assigned to
    source cohort j, copy cohort j's LD rows/columns and r entries for
    those indices into cohort k's arrays.
    """
    K = len(Rs)
    dense = [np.asarray(R.todense()) if scipy.sparse.issparse(R) else np.array(R)
             for R in Rs]
    out_r = [r.copy() for r in rs]
    for k in range(K):
        for j in range(K):
            if j == k:
                continue
            take = panel.missing[k][panel.sources[k][panel.missing[k]] == j]
            if take.size == 0:
                continue
            dense[k][take, :] = dense[j][take, :]
            dense[k][:, take] = dense[j][:, take]
            out_r[k][take] = rs[j][take]
    return dense, out_r


def csr_to_band(R, bandwidth: Optional[int] = None,
                dtype=np.float32) -> Tuple[np.ndarray, int, int]:
    """Convert a scipy sparse (or dense) symmetric matrix to symmetric band
    storage (M, 2*bw+1) without densifying MxM.

    Returns (band, bandwidth, dropped_entries). Entries outside the chosen
    bandwidth are dropped (counted); the diagonal is taken from the matrix
    itself (the reference's CSR carries the unit diagonal explicitly,
    src/main.py:255).
    """
    if scipy.sparse.issparse(R) and np.dtype(dtype) == np.float32:
        # native fast path: one row-ordered pass over the CSR (the COO
        # expansion + mask + fancy scatter below measured 25 s of the 53 s
        # biobank ingestion at M=512k / 135M nnz; this pass takes ~1 s)
        from sgvamp import native

        Rc = R.tocsr()
        # non-canonical CSR may itself carry duplicate column indices,
        # which scipy SUMS on use but the native one-pass writer would
        # last-write-win; canonicalize so both paths agree. On a COPY:
        # tocsr() of a csr_matrix returns SELF, and sum_duplicates would
        # mutate the caller's arrays in place.
        if not Rc.has_canonical_format:
            Rc = Rc.copy()
            Rc.sum_duplicates()
        M = Rc.shape[0]
        bw = bandwidth
        if bw is None:
            bw = native.csr_max_bandwidth(Rc.indptr, Rc.indices, M)
        if bw is not None:
            got = native.csr_to_band(Rc.indptr, Rc.indices, Rc.data, M, bw)
            if got is not None:
                band, dropped = got
                return band, int(bw), dropped
    coo = scipy.sparse.coo_matrix(R)
    # duplicate entries SUM (scipy csr semantics, the reference's
    # csr_matrix triplet build src/main.py:251-257) - without this the
    # fancy scatter below would be last-write-wins and the native fast
    # path (which goes through tocsr()) would disagree on non-canonical
    # COO input
    coo.sum_duplicates()
    d = coo.col - coo.row
    if bandwidth is None:
        bandwidth = int(np.abs(d).max()) if d.size else 0
    band = np.zeros((R.shape[0], 2 * bandwidth + 1), dtype)
    keep = np.abs(d) <= bandwidth
    band[coo.row[keep], bandwidth + d[keep]] = coo.data[keep]
    return band, bandwidth, int((~keep).sum())


def fill_missing_triplets(
    triplets: List[Tuple[np.ndarray, np.ndarray, np.ndarray]],
    rs: List[np.ndarray],
    panel: HarmonizedPanel,
) -> Tuple[List[Tuple[np.ndarray, np.ndarray, np.ndarray]], List[np.ndarray]]:
    """Triplet-level missing-SNP fill (the band-direct analogue of
    fill_missing_from_source, mirroring the reference's triplet append,
    src/main.py:223-249): cohort k receives, from each source cohort j, all
    of j's LD triplets touching k's missing indices assigned to j, plus
    j's r values there."""
    K = len(triplets)
    out_t = [list(t) for t in triplets]
    out_r = [r.copy() for r in rs]
    for k in range(K):
        for j in range(K):
            if j == k:
                continue
            take = panel.missing[k][panel.sources[k][panel.missing[k]] == j]
            if take.size == 0:
                continue
            aj, bj, vj = triplets[j]
            sel = np.isin(aj, take) | np.isin(bj, take)
            out_t[k][0] = np.concatenate([out_t[k][0], aj[sel]])
            out_t[k][1] = np.concatenate([out_t[k][1], bj[sel]])
            out_t[k][2] = np.concatenate([out_t[k][2], vj[sel]])
            out_r[k][take] = rs[j][take]
    return [tuple(t) for t in out_t], out_r


def ld_files_to_bands(
    ld_paths: Sequence[str],
    rs: List[np.ndarray],
    panel: HarmonizedPanel,
    bandwidth: Optional[int] = None,
    dtype=np.float32,
) -> Tuple[np.ndarray, List[np.ndarray], int, int]:
    """Load PLINK .ld files straight into symmetric band storage (K, M, nd)
    without ever materializing MxM - the biobank-scale ingestion path.

    Returns (bands, filled_rs, bandwidth, dropped_entries).
    """
    from sgvamp import native

    vindex = {rs_: i for i, rs_ in enumerate(panel.variants)}
    M = panel.M
    triplets = [load_ld_table(p, vindex) for p in ld_paths]
    if len(ld_paths) > 1:
        triplets, rs = fill_missing_triplets(triplets, rs, panel)
    if bandwidth is None:
        bandwidth = 0
        for a, b, _ in triplets:
            if len(a):
                got = native.max_bandwidth(a, b)
                w = got if got is not None else int(np.abs(a - b).max())
                bandwidth = max(bandwidth, w)
    bands = np.zeros((len(ld_paths), M, 2 * bandwidth + 1), dtype)
    dropped = 0
    for k, (a, b, v) in enumerate(triplets):
        got = native.triplets_to_band(a, b, v, M, bandwidth, dtype=dtype)
        if got is not None:
            bands[k], d = got
        else:  # pure-Python fallback
            band = np.zeros((M, 2 * bandwidth + 1), dtype)
            band[:, bandwidth] = 1.0
            dmask = np.abs(b - a) <= bandwidth
            d = int((~dmask).sum())
            for aa, bb, vv in zip(a[dmask], b[dmask], v[dmask]):
                band[aa, bandwidth + (bb - aa)] = vv
                band[bb, bandwidth - (bb - aa)] = vv
            bands[k] = band
        dropped += d
    return bands, rs, bandwidth, dropped


# ---------------------------------------------------------------------------
# true signal
# ---------------------------------------------------------------------------

def load_true_signal(path: str, M: int, N: float) -> np.ndarray:
    """Load x0 and scale by sqrt(N) (reference src/main.py:269-285).

    Strict length validation: a signal file of the wrong length means a
    mismatched panel (wrong -M, stale file), and truncating or accepting
    it silently would corrupt every downstream alignment/L2 metric."""
    if path.endswith(".bin"):
        with open(path, "rb") as f:
            buf = f.read(M * 8 + 8)
        if len(buf) != M * 8:
            raise ValueError(
                f"{path}: {len(buf) // 8}{'+' if len(buf) > M * 8 else ''} "
                f"float64 values, expected exactly M={M}")
        x0 = np.asarray(struct.unpack(str(M) + "d", buf), dtype=np.float64)
    elif path.endswith(".npy"):
        x0 = np.load(path).astype(np.float64).reshape(-1)
        if x0.size != M:
            raise ValueError(
                f"{path}: {x0.size} values, expected exactly M={M}")
    else:
        raise ValueError(f"Unsupported true signal format: {path}")
    return x0 * np.sqrt(N)


# ---------------------------------------------------------------------------
# densification for the dense operators
# ---------------------------------------------------------------------------

def to_dense_stack(Rs: Sequence, M: int) -> np.ndarray:
    """Stack per-cohort LD matrices into a dense (K, M, M) float array."""
    out = np.empty((len(Rs), M, M), dtype=np.float64)
    for k, R in enumerate(Rs):
        out[k] = np.asarray(R.todense()) if scipy.sparse.issparse(R) else np.asarray(R)
    return out


def estimate_bandwidth(R, quantile: float = 1.0) -> int:
    """Max |i-j| over nonzero entries (optionally a quantile for outlier-
    robust banding). Used to pick BandedLD bandwidth for sparse LD."""
    if scipy.sparse.issparse(R):
        coo = R.tocoo()
        d = np.abs(coo.row - coo.col)
    else:
        nz = np.nonzero(np.asarray(R))
        d = np.abs(nz[0] - nz[1])
    if d.size == 0:
        return 0
    if quantile >= 1.0:
        return int(d.max())
    return int(np.quantile(d, quantile))
