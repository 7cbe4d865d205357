"""Native C++ ldparse tests: parity with the pandas path, band assembly,
error handling, and a (coarse) speed sanity check."""

import os
import time

import numpy as np
import pandas as pd
import pytest

from sgvamp import native
from sgvamp.data import loaders
from sgvamp.data.simulate import band_to_dense


def _write_ld(path, rows, cols, vals, variants):
    df = pd.DataFrame({
        "CHR_A": 1, "BP_A": rows + 1, "SNP_A": [variants[i] for i in rows],
        "CHR_B": 1, "BP_B": cols + 1, "SNP_B": [variants[i] for i in cols],
        "R": vals,
    })
    df.to_csv(path, sep="\t", index=False)


@pytest.fixture(scope="module")
def lib_available():
    if native.get_lib() is None:
        pytest.skip("g++ unavailable; native path not built")


def test_parse_matches_pandas(tmp_path, lib_available):
    rng = np.random.default_rng(0)
    M, nnz = 200, 500
    variants = [f"rs{i}" for i in range(M)]
    rows = rng.integers(0, M - 1, nnz)
    cols = np.minimum(rows + rng.integers(1, 20, nnz), M - 1)
    vals = rng.normal(size=nnz).round(6)
    path = tmp_path / "panel.ld"
    _write_ld(str(path), rows, cols, vals, variants)

    a, b, v = native.parse_ld(str(path), variants)
    os.environ["SGVAMP_NO_NATIVE"] = "1"
    try:
        vindex = {rs: i for i, rs in enumerate(variants)}
        a2, b2, v2 = loaders.load_ld_table(str(path), vindex)
    finally:
        del os.environ["SGVAMP_NO_NATIVE"]
    np.testing.assert_array_equal(a, a2)
    np.testing.assert_array_equal(b, b2)
    np.testing.assert_allclose(v, v2)


def test_parse_error_paths(tmp_path, lib_available):
    variants = ["rs0", "rs1"]
    bad = tmp_path / "bad.ld"
    bad.write_text("CHR_A BP_A SNP_A CHR_B BP_B SNP_B R\n1 1 rsX 1 2 rs1 0.5\n")
    with pytest.raises(ValueError, match="unknown SNP"):
        native.parse_ld(str(bad), variants)
    noheader = tmp_path / "nh.ld"
    noheader.write_text("A B C\n1 2 3\n")
    with pytest.raises(ValueError, match="missing SNP_A"):
        native.parse_ld(str(noheader), variants)
    with pytest.raises(ValueError, match="cannot open"):
        native.parse_ld(str(tmp_path / "absent.ld"), variants)


def test_band_assembly_matches_csr(tmp_path, lib_available):
    rng = np.random.default_rng(1)
    M, nnz = 150, 300
    rows = rng.integers(0, M - 1, nnz)
    cols = np.minimum(rows + rng.integers(1, 12, nnz), M - 1)
    vals = rng.normal(size=nnz)
    bw = native.max_bandwidth(rows, cols)
    assert bw == int(np.abs(rows - cols).max())
    band, dropped = native.triplets_to_band(rows, cols, vals, M, bw)
    assert dropped == 0
    R_band = band_to_dense(band.astype(np.float64))
    R_csr = loaders.triplets_to_csr(rows, cols, vals, M).toarray()
    # duplicate triplets: CSR sums, band keeps the last write - compare on
    # a duplicate-free subset instead
    pairs = set()
    dup_free = np.ones(nnz, bool)
    for i, (r0, c0) in enumerate(zip(rows, cols)):
        key = (min(r0, c0), max(r0, c0))
        if key in pairs:
            dup_free[i] = False
        pairs.add(key)
    if dup_free.all():
        np.testing.assert_allclose(R_band, R_csr, atol=1e-6)
    else:
        band2, _ = native.triplets_to_band(rows[dup_free], cols[dup_free],
                                           vals[dup_free], M, bw)
        R2 = loaders.triplets_to_csr(rows[dup_free], cols[dup_free],
                                     vals[dup_free], M).toarray()
        np.testing.assert_allclose(band_to_dense(band2.astype(np.float64)),
                                   R2, atol=1e-6)


def test_csr_to_band_native_matches_python(lib_available):
    """The direct CSR->band pass (the loaders.csr_to_band fast path) must
    equal the Python COO-scatter path: same band, bandwidth, and dropped
    count - including out-of-band entries and both index dtypes."""
    import os

    import scipy.sparse

    rng = np.random.default_rng(3)
    M = 400
    dense = np.zeros((M, M), np.float32)
    for _ in range(1500):
        i, j = rng.integers(0, M, 2)
        dense[i, j] = dense[j, i] = rng.normal()
    np.fill_diagonal(dense, 1.0)
    # a few far off-band entries that a bw=32 conversion must drop
    dense[0, M - 1] = dense[M - 1, 0] = 0.5
    R = scipy.sparse.csr_matrix(dense)

    os.environ["SGVAMP_NO_NATIVE"] = "1"
    try:
        band_py, bw_py, drop_py = loaders.csr_to_band(R, 32)
        band_py_auto, bw_auto_py, _ = loaders.csr_to_band(R, None)
    finally:
        del os.environ["SGVAMP_NO_NATIVE"]

    for idx_dtype in (np.int32, np.int64):
        Rc = R.copy()
        Rc.indptr = Rc.indptr.astype(idx_dtype)
        Rc.indices = Rc.indices.astype(idx_dtype)
        band_c, bw_c, drop_c = loaders.csr_to_band(Rc, 32)
        assert (bw_c, drop_c) == (bw_py, drop_py) and drop_c > 0
        np.testing.assert_array_equal(band_c, band_py)
        band_a, bw_a, _ = loaders.csr_to_band(Rc, None)
        assert bw_a == bw_auto_py == M - 1
        np.testing.assert_array_equal(band_a, band_py_auto)
    # float64 data also takes the native path (f32 band out)
    R64 = scipy.sparse.csr_matrix(dense.astype(np.float64))
    band_d, bw_d, drop_d = loaders.csr_to_band(R64, 32)
    assert (bw_d, drop_d) == (bw_py, drop_py)
    np.testing.assert_array_equal(band_d, band_py)


def test_band_pack_i8_native_matches_numpy(lib_available):
    """SymBandedLD.from_band's native int8 pack must be BIT-identical to
    the numpy path (same blocks, same scales): ragged M (pad rows with
    unit diagonal), bw not a block multiple, zero edge blocks, negative
    and >1 values."""
    import os

    from sgvamp.ops.band_kernel import SymBandedLD

    rng = np.random.default_rng(7)
    for M, bw, B in ((1000, 96, 128), (512, 64, 64), (300, 300, 128)):
        band = rng.normal(scale=0.4, size=(M, 2 * bw + 1)).astype(np.float32)
        band[:, bw] = 1.0
        band[5] *= 4.0  # exercise clipping range
        # band storage invariant: entries past the matrix edge are zero
        for i in range(M):
            for d in range(1, bw + 1):
                if i + d >= M:
                    band[i, bw + d] = 0.0
                if i - d < 0:
                    band[i, bw - d] = 0.0
        op_native = SymBandedLD.from_band(band, block_size=B, dtype="int8")
        os.environ["SGVAMP_NO_NATIVE"] = "1"
        try:
            op_py = SymBandedLD.from_band(band, block_size=B, dtype="int8")
        finally:
            del os.environ["SGVAMP_NO_NATIVE"]
        np.testing.assert_array_equal(np.asarray(op_native.upper),
                                      np.asarray(op_py.upper))
        np.testing.assert_array_equal(np.asarray(op_native.scales),
                                      np.asarray(op_py.scales))


def test_stale_so_rebuilds(tmp_path, lib_available, monkeypatch):
    """A stale or corrupt _ldparse.so with a fresh mtime (copied checkout,
    extracted archive) must trigger a rebuild from source, not crash.
    Uses a temp library path - never touches the dlopen'ed real .so
    (overwriting a mapped library corrupts the running process)."""
    import os
    import time as _time

    fake = tmp_path / "_ldparse.so"
    fake.write_bytes(b"not a shared library")
    future = _time.time() + 3600
    os.utime(fake, (future, future))  # defeats the mtime freshness check
    monkeypatch.setattr(native, "_LIB", str(fake))
    monkeypatch.setattr(native, "_tried", False)
    monkeypatch.setattr(native, "_lib", None)
    lib = native.get_lib()
    assert lib is not None  # rebuilt from ldparse.cpp into the temp path
    assert hasattr(lib, "ldparse_band_pack_i8")
    monkeypatch.setattr(native, "_tried", False)
    monkeypatch.setattr(native, "_lib", None)


def test_native_speed_sanity(tmp_path, lib_available):
    """Native parse should beat pandas comfortably on a larger table."""
    rng = np.random.default_rng(2)
    M, nnz = 5000, 200_000
    variants = [f"rs{i}" for i in range(M)]
    rows = rng.integers(0, M - 1, nnz)
    cols = np.minimum(rows + rng.integers(1, 50, nnz), M - 1)
    vals = rng.normal(size=nnz).round(6)
    path = tmp_path / "big.ld"
    _write_ld(str(path), rows, cols, vals, variants)

    t0 = time.time()
    a, b, v = native.parse_ld(str(path), variants)
    native_s = time.time() - t0

    vindex = {rs: i for i, rs in enumerate(variants)}
    t0 = time.time()
    df = pd.read_table(str(path), sep=r"\s+")
    a2 = np.asarray([vindex[rs] for rs in df["SNP_A"]])
    pandas_s = time.time() - t0

    assert len(a) == nnz
    assert native_s < pandas_s  # typically 5-20x faster


def test_stale_real_so_rebuilds(tmp_path, lib_available, monkeypatch):
    """A VALID but outdated .so - one that dlopens fine and fails only
    partway through symbol binding, leaving a live handle - must still
    recover. The rebuild loads under a unique temp filename (glibc
    resolves dlopen by pathname, so reloading the same path can return
    the stale mapping) and is then promoted to the library path."""
    import os
    import subprocess
    import time as _time

    src = tmp_path / "old.cpp"
    src.write_text('extern "C" void* ldparse_parse(const char*, const char*,'
                   ' long long) { return 0; }\n')
    stale = tmp_path / "_ldparse.so"
    subprocess.run(["g++", "-O2", "-shared", "-fPIC", str(src),
                    "-o", str(stale)], check=True)
    stub_size = os.path.getsize(stale)
    future = _time.time() + 3600
    os.utime(stale, (future, future))  # defeats the mtime freshness check
    monkeypatch.setattr(native, "_LIB", str(stale))
    monkeypatch.setattr(native, "_tried", False)
    monkeypatch.setattr(native, "_lib", None)
    lib = native.get_lib()
    assert lib is not None
    assert hasattr(lib, "ldparse_band_pack_i8")  # newest symbol bound
    # the good rebuild was promoted over the stale path for future runs
    assert os.path.getsize(stale) != stub_size
    monkeypatch.setattr(native, "_tried", False)
    monkeypatch.setattr(native, "_lib", None)


def test_csr_to_band_duplicate_entries_sum(lib_available):
    """Non-canonical sparse input with duplicate entries: both the native
    CSR fast path (tocsr() sums) and the COO fallback must SUM duplicates
    (scipy csr semantics, the reference's triplet build src/main.py:
    251-257), not last-write-wins."""
    import scipy.sparse

    from sgvamp.data import loaders

    M = 8
    rows = np.asarray([0, 1, 1, 3, 3, 3])
    cols = np.asarray([1, 2, 2, 4, 4, 5])
    vals = np.asarray([0.5, 0.25, 0.25, 0.1, 0.2, 0.3])
    coo = scipy.sparse.coo_matrix((vals, (rows, cols)), shape=(M, M))
    want = coo.tocsr().toarray()

    band_native, bw, dropped = loaders.csr_to_band(coo.tocsr(),
                                                   dtype=np.float32)
    # NON-canonical CSR input (duplicate column indices inside a row):
    # scipy sums these on use; the native one-pass writer must see
    # canonicalized arrays, not last-write-win
    import scipy.sparse as _sp

    dup_csr = _sp.csr_matrix(
        (np.asarray([0.25, 0.25, 0.5]), np.asarray([2, 2, 1]),
         np.asarray([0, 2, 3] + [3] * (M - 2))), shape=(M, M))
    assert not dup_csr.has_canonical_format
    band_dup, bwd, _ = loaders.csr_to_band(dup_csr, dtype=np.float32)
    assert band_dup[0, bwd + 2] == np.float32(0.5)  # 0.25 + 0.25 summed
    import os
    os.environ["SGVAMP_NO_NATIVE"] = "1"
    try:
        band_py, bw2, _ = loaders.csr_to_band(coo, dtype=np.float32)
    finally:
        del os.environ["SGVAMP_NO_NATIVE"]
    assert bw == bw2
    np.testing.assert_allclose(band_py, band_native, rtol=1e-7)
    # and both match the summed-duplicate ground truth
    dense = np.zeros((M, M))
    for i in range(M):
        for d in range(-bw, bw + 1):
            if 0 <= i + d < M:
                dense[i, i + d] = band_py[i, bw + d]
    np.testing.assert_allclose(dense, want, rtol=1e-7)
