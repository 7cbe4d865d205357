"""PLINK output converters (reference scripts/plink2np.py behavior).

One shared CSR-assembly implementation (loaders.triplets_to_csr) serves
both this converter and the .ld runtime loader, per SURVEY 3.4's note that
the reference duplicates the idiom.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import scipy.sparse

from sgvamp.data import tables
from sgvamp.data.loaders import triplets_to_csr


def linear_to_npy(linear_path: str, out_path: str | None = None) -> Tuple[str, np.ndarray]:
    """Extract the BETA column of a .assoc.linear file to .npy
    (reference scripts/plink2np.py:27-31)."""
    r = tables.to_float(tables.read_columns(linear_path, ["BETA"])["BETA"])
    out = out_path or linear_path.split(".assoc.linear")[0] + ".npy"
    np.save(out, r)
    return out, r


def ld_to_npz(ld_path: str, linear_path: str, out_path: str | None = None) -> str:
    """Convert a PLINK .ld table to a symmetric unit-diagonal CSR .npz,
    indexing SNPs by the .linear file's SNP order
    (reference scripts/plink2np.py:33-49)."""
    snps = tables.read_columns(linear_path, ["SNP"])["SNP"]
    idx = {rs: i for i, rs in enumerate(snps)}
    M = len(snps)
    ld = tables.read_columns(ld_path, ["SNP_A", "SNP_B", "R"])
    rows = np.asarray([idx[rs] for rs in ld["SNP_A"]], dtype=np.int64)
    cols = np.asarray([idx[rs] for rs in ld["SNP_B"]], dtype=np.int64)
    vals = tables.to_float(ld["R"])
    R = triplets_to_csr(rows, cols, vals, M)
    out = out_path or ld_path.split(".ld")[0] + ".npz"
    scipy.sparse.save_npz(out, R, compressed=True)
    return out
