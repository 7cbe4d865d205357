"""Native (C++) fast paths, bound via ctypes.

The shared library is compiled from ldparse.cpp with g++ on first use and
cached next to the source; every entry point has a pure-Python fallback in
data/loaders.py, selected automatically when compilation is unavailable
(set SGVAMP_NO_NATIVE=1 to force the fallback).
"""

from __future__ import annotations

import ctypes
import logging
import os
import subprocess
import threading
from typing import Optional, Tuple

import numpy as np

logger = logging.getLogger("sgvamp")

_SRC = os.path.join(os.path.dirname(__file__), "ldparse.cpp")
_LIB = os.path.join(os.path.dirname(__file__), "_ldparse.so")
_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None
_tried = False


def _build(out: str = "") -> Optional[str]:
    out = out or _LIB
    if (out == _LIB and os.path.exists(_LIB)
            and os.path.getmtime(_LIB) >= os.path.getmtime(_SRC)):
        return _LIB
    cmd = ["g++", "-O3", "-std=c++17", "-shared", "-fPIC", _SRC, "-o", out]
    try:
        subprocess.run(cmd, check=True, capture_output=True, timeout=120)
        return out
    except (subprocess.SubprocessError, FileNotFoundError) as e:
        logger.debug(f"native ldparse build failed ({e}); using Python fallback")
        return None


def get_lib() -> Optional[ctypes.CDLL]:
    """Load (building if needed) the native library, or None."""
    global _lib, _tried
    if os.environ.get("SGVAMP_NO_NATIVE"):
        return None
    with _lock:
        if _tried:
            return _lib
        _tried = True
        path = _build()
        if path is None:
            return None
        try:
            _lib = _bind(ctypes.CDLL(path))
        except (AttributeError, OSError):
            # A stale .so with a fresh mtime (copied checkout, extracted
            # archive, shipped prebuilt) lacks newer symbols: force one
            # rebuild from source, else keep the Python fallback. The
            # rebuild goes to a UNIQUE temp filename: the failed CDLL above
            # may hold a dlopen handle for _LIB's pathname, and glibc
            # resolves dlopen by pathname first — reloading the same path
            # can return the already-mapped stale object, silently re-failing
            # the bind. A fresh name guarantees a fresh mapping.
            import tempfile

            fd, tmp = tempfile.mkstemp(suffix=".so",
                                       dir=os.path.dirname(_LIB))
            os.close(fd)
            path = _build(tmp)
            if path is None:
                try:
                    os.remove(tmp)
                except OSError:
                    pass
                return None
            try:
                _lib = _bind(ctypes.CDLL(path))
            except (AttributeError, OSError) as e:
                logger.debug(f"native ldparse unusable ({e}); Python fallback")
                _lib = None
                try:
                    os.remove(tmp)
                except OSError:
                    pass
            else:
                # promote the good build for future processes; the current
                # mapping tracks the inode, so the rename is safe (never
                # overwrite a mapped .so in place)
                try:
                    os.replace(tmp, _LIB)
                except OSError:
                    pass
        return _lib


def _bind(lib: ctypes.CDLL) -> ctypes.CDLL:
    """Declare every exported symbol's signature; raises AttributeError
    if the loaded .so predates a symbol (handled by get_lib)."""
    lib.ldparse_parse.restype = ctypes.c_void_p
    lib.ldparse_parse.argtypes = [ctypes.c_char_p, ctypes.c_char_p, ctypes.c_int64]
    lib.ldparse_error.restype = ctypes.c_char_p
    lib.ldparse_error.argtypes = [ctypes.c_void_p]
    lib.ldparse_count.restype = ctypes.c_int64
    lib.ldparse_count.argtypes = [ctypes.c_void_p]
    lib.ldparse_copy.restype = None
    lib.ldparse_copy.argtypes = [
        ctypes.c_void_p,
        ctypes.POINTER(ctypes.c_int64),
        ctypes.POINTER(ctypes.c_int64),
        ctypes.POINTER(ctypes.c_double),
    ]
    lib.ldparse_free.restype = None
    lib.ldparse_free.argtypes = [ctypes.c_void_p]
    lib.ldparse_max_bandwidth.restype = ctypes.c_int64
    lib.ldparse_max_bandwidth.argtypes = [
        ctypes.c_int64,
        ctypes.POINTER(ctypes.c_int64),
        ctypes.POINTER(ctypes.c_int64),
    ]
    lib.ldparse_to_band.restype = ctypes.c_int64
    lib.ldparse_to_band.argtypes = [
        ctypes.c_int64,
        ctypes.POINTER(ctypes.c_int64),
        ctypes.POINTER(ctypes.c_int64),
        ctypes.POINTER(ctypes.c_double),
        ctypes.c_int64,
        ctypes.c_int64,
        ctypes.POINTER(ctypes.c_float),
    ]
    lib.ldparse_to_band_f64.restype = ctypes.c_int64
    lib.ldparse_to_band_f64.argtypes = [
        ctypes.c_int64,
        ctypes.POINTER(ctypes.c_int64),
        ctypes.POINTER(ctypes.c_int64),
        ctypes.POINTER(ctypes.c_double),
        ctypes.c_int64,
        ctypes.c_int64,
        ctypes.POINTER(ctypes.c_double),
    ]
    f32p = ctypes.POINTER(ctypes.c_float)
    f64p = ctypes.POINTER(ctypes.c_double)
    for iname, ip in (("i32", ctypes.POINTER(ctypes.c_int32)),
                      ("i64", ctypes.POINTER(ctypes.c_int64))):
        for vname, vp in (("f32", f32p), ("f64", f64p)):
            fn = getattr(lib, f"ldparse_csr_to_band_{iname}_{vname}")
            fn.restype = ctypes.c_int64
            fn.argtypes = [ctypes.c_int64, ip, ip, vp, ctypes.c_int64,
                           f32p]
        fn = getattr(lib, f"ldparse_csr_max_bw_{iname}")
        fn.restype = ctypes.c_int64
        fn.argtypes = [ctypes.c_int64, ip, ip]
    lib.ldparse_band_pack_i8.restype = None
    lib.ldparse_band_pack_i8.argtypes = [
        f32p, ctypes.c_int64, ctypes.c_int64, ctypes.c_int64,
        ctypes.c_int64, ctypes.c_int64,
        ctypes.POINTER(ctypes.c_int8), f32p,
    ]
    return lib


def _i64p(x: np.ndarray):
    return x.ctypes.data_as(ctypes.POINTER(ctypes.c_int64))


def _f64p(x: np.ndarray):
    return x.ctypes.data_as(ctypes.POINTER(ctypes.c_double))


def parse_ld(path: str, variants) -> Optional[Tuple[np.ndarray, np.ndarray, np.ndarray]]:
    """Parse a PLINK .ld table natively. Returns (rows, cols, vals) in
    reference index space, or None if the native library is unavailable."""
    lib = get_lib()
    if lib is None:
        return None
    blob = "\n".join(variants).encode()
    h = lib.ldparse_parse(path.encode(), blob, len(variants))
    if not h:
        raise MemoryError("ldparse_parse allocation failed")
    try:
        err = lib.ldparse_error(h)
        if err:
            raise ValueError(f"ldparse: {err.decode()} in {path}")
        n = lib.ldparse_count(h)
        a = np.empty(n, np.int64)
        b = np.empty(n, np.int64)
        v = np.empty(n, np.float64)
        if n:
            lib.ldparse_copy(h, _i64p(a), _i64p(b), _f64p(v))
        return a, b, v
    finally:
        lib.ldparse_free(h)


def max_bandwidth(rows: np.ndarray, cols: np.ndarray) -> Optional[int]:
    lib = get_lib()
    if lib is None:
        return None
    rows = np.ascontiguousarray(rows, np.int64)
    cols = np.ascontiguousarray(cols, np.int64)
    return int(lib.ldparse_max_bandwidth(len(rows), _i64p(rows), _i64p(cols)))


def band_pack_i8(band: np.ndarray, B: int
                 ) -> Optional[Tuple[np.ndarray, np.ndarray]]:
    """Pack float32 band storage (M, 2*bw+1) into int8 upper-triangle
    blocks (nb, hb+1, B, B) with per-block float32 scales, bit-identical
    to SymBandedLD.from_band's numpy path (incl. pad rows' unit diagonal
    and the past-matrix zero-block invariant). Returns (upper, scales)
    or None if unavailable."""
    lib = get_lib()
    if lib is None or band.dtype != np.float32:
        return None
    band = np.ascontiguousarray(band)
    M_orig, nd = band.shape
    bw = (nd - 1) // 2
    nb = -(-M_orig // B)
    hb = -(-bw // B)
    upper = np.empty((nb, hb + 1, B, B), np.int8)
    scales = np.empty((nb, hb + 1), np.float32)
    lib.ldparse_band_pack_i8(
        band.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
        M_orig, nd, B, nb, hb,
        upper.ctypes.data_as(ctypes.POINTER(ctypes.c_int8)),
        scales.ctypes.data_as(ctypes.POINTER(ctypes.c_float)))
    return upper, scales


def _csr_suffixes(indptr: np.ndarray, indices: np.ndarray, data: np.ndarray):
    """(index_suffix, value_suffix) for the CSR entry points, or None when
    the dtype combination has no native symbol."""
    if indptr.dtype != indices.dtype:
        return None
    iname = {np.dtype(np.int32): "i32", np.dtype(np.int64): "i64"}.get(indptr.dtype)
    vname = {np.dtype(np.float32): "f32", np.dtype(np.float64): "f64"}.get(data.dtype)
    if iname is None or vname is None:
        return None
    return iname, vname


def csr_to_band(indptr: np.ndarray, indices: np.ndarray, data: np.ndarray,
                M: int, bw: int) -> Optional[Tuple[np.ndarray, int]]:
    """Symmetric band storage (M, 2*bw+1) float32 straight from CSR arrays
    (one row-ordered pass; no COO expansion). The diagonal comes from the
    matrix itself, matching data/loaders.csr_to_band's Python path.
    Returns (band, dropped_count), or None if unavailable."""
    lib = get_lib()
    if lib is None:
        return None
    sfx = _csr_suffixes(indptr, indices, data)
    if sfx is None:
        return None
    indptr = np.ascontiguousarray(indptr)
    indices = np.ascontiguousarray(indices)
    data = np.ascontiguousarray(data)
    band = np.zeros((M, 2 * bw + 1), np.float32)
    ip = ctypes.POINTER(ctypes.c_int32 if sfx[0] == "i32" else ctypes.c_int64)
    vp = ctypes.POINTER(ctypes.c_float if sfx[1] == "f32" else ctypes.c_double)
    fn = getattr(lib, f"ldparse_csr_to_band_{sfx[0]}_{sfx[1]}")
    dropped = fn(M, indptr.ctypes.data_as(ip), indices.ctypes.data_as(ip),
                 data.ctypes.data_as(vp), bw,
                 band.ctypes.data_as(ctypes.POINTER(ctypes.c_float)))
    return band, int(dropped)


def csr_max_bandwidth(indptr: np.ndarray, indices: np.ndarray,
                      M: int) -> Optional[int]:
    lib = get_lib()
    if lib is None:
        return None
    sfx = _csr_suffixes(indptr, indices, np.empty(0, np.float32))
    if sfx is None:
        return None
    indptr = np.ascontiguousarray(indptr)
    indices = np.ascontiguousarray(indices)
    ip = ctypes.POINTER(ctypes.c_int32 if sfx[0] == "i32" else ctypes.c_int64)
    fn = getattr(lib, f"ldparse_csr_max_bw_{sfx[0]}")
    return int(fn(M, indptr.ctypes.data_as(ip), indices.ctypes.data_as(ip)))


def triplets_to_band(rows: np.ndarray, cols: np.ndarray, vals: np.ndarray,
                     M: int, bw: int, dtype=np.float32
                     ) -> Optional[Tuple[np.ndarray, int]]:
    """Assemble symmetric band storage (M, 2*bw+1) with unit diagonal from
    one-sided triplets. Returns (band, dropped_count)."""
    lib = get_lib()
    if lib is None:
        return None
    rows = np.ascontiguousarray(rows, np.int64)
    cols = np.ascontiguousarray(cols, np.int64)
    vals = np.ascontiguousarray(vals, np.float64)
    dtype = np.dtype(dtype)
    band = np.zeros((M, 2 * bw + 1), dtype)
    if dtype == np.float64:
        dropped = lib.ldparse_to_band_f64(
            len(rows), _i64p(rows), _i64p(cols), _f64p(vals), M, bw, _f64p(band))
    else:
        dropped = lib.ldparse_to_band(
            len(rows), _i64p(rows), _i64p(cols), _f64p(vals), M, bw,
            band.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
        )
    return band, int(dropped)
