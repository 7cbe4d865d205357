"""SNP harmonization across cohorts from PLINK .bim files.

Reimplements the reference's .bim handling (reference src/main.py:126-165)
in one process: read K .bim files, outer-merge variant lists into a
reference panel sorted by coordinate, and build per-cohort index maps
(local index -> reference index). Where the reference assigns each
locally-missing SNP a "source" MPI rank to fetch LD rows from at load time
(src/main.py:156-164, 211-249), the single-driver design resolves missing
data by construction during the merge (see loaders.fill_missing_from_source).
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence

import numpy as np

from sgvamp.data import tables

BIM_COLUMNS = ["Chromosome", "Variant", "Position", "Coordinate", "Allele1", "Allele2"]


@dataclasses.dataclass
class HarmonizedPanel:
    """Result of cross-cohort SNP harmonization.

    variants:  reference variant list (length M), coordinate-sorted.
    M:         reference panel size.
    i_maps:    per-cohort local->reference index arrays.
    sources:   per-cohort (M,) int arrays: for each reference SNP, the
               cohort that supplies its data for this cohort - itself when
               present locally, else the holder cohort with the largest N
               (reference src/main.py:156-164).
    missing:   per-cohort sets of reference indices absent locally.
    """

    variants: List[str]
    M: int
    i_maps: List[np.ndarray]
    sources: List[np.ndarray]
    missing: List[np.ndarray]


def read_bim(path: str) -> List[List[str]]:
    """Rows of a .bim file: the six BIM_COLUMNS fields as strings."""
    return [row[:len(BIM_COLUMNS)] for row in tables.read_rows(path)]


def harmonize(
    bim_paths: Sequence[str],
    N_list: Sequence[float],
    out_bim_path: Optional[str] = None,
) -> HarmonizedPanel:
    """Merge K cohort .bim files into a reference panel.

    Mirrors the reference merge: one cohort keeps its file order; K >= 2
    cohorts are outer-joined on Variant only (the union of variants in
    lexicographic order, metadata from the first cohort that lists each
    one). Then a stable sort by Coordinate (reference src/main.py:139-142),
    so tied Coordinates, common across chromosomes, keep that order. The
    merged .bim is optionally written (reference writes it on rank 0,
    :148-150). The reference keeps NaN metadata and crashes at K>=3 when
    its '_y' merge suffix collides; here every variant's metadata comes
    from a cohort that has it.
    """
    K = len(bim_paths)
    bims = [read_bim(p) for p in bim_paths]
    vcol = BIM_COLUMNS.index("Variant")
    first: Dict[str, List[str]] = {}
    for bim in bims:
        for row in bim:
            first.setdefault(row[vcol], row)
    union = list(first) if K == 1 else sorted(first)
    coords = tables.to_float([first[v][BIM_COLUMNS.index("Coordinate")]
                              for v in union])
    order = np.argsort(coords, kind="stable")
    variants = [union[i] for i in order]
    M = len(variants)
    if out_bim_path is not None:
        with open(out_bim_path, "w") as f:
            f.writelines("\t".join(first[v]) + "\n" for v in variants)

    idx: Dict[str, int] = {rs: i for i, rs in enumerate(variants)}
    N_arr = np.asarray(N_list, dtype=np.float64)

    # Vectorized holder assignment (the reference loops Python-side per
    # missing variant, src/main.py:156-164; at M~1M that is minutes). One
    # (K, M) presence table + a masked argmax reproduces its choice - the
    # largest-N holder, first cohort on ties - in O(K*M).
    i_maps = [np.asarray([idx[row[vcol]] for row in bims[k]], dtype=np.int64)
              for k in range(K)]
    present = np.zeros((K, M), dtype=bool)
    for k in range(K):
        present[k, i_maps[k]] = True

    sources, missing = [], []
    for k in range(K):
        source = np.full(M, k, dtype=np.int64)
        miss = np.flatnonzero(~present[k])
        if miss.size:
            scores = np.where(present[:, miss], N_arr[:, None], -np.inf)
            source[miss] = np.argmax(scores, axis=0)
        sources.append(source)
        missing.append(miss.astype(np.int64))
    return HarmonizedPanel(
        variants=variants, M=M, i_maps=i_maps, sources=sources,
        missing=missing,
    )


def identity_panel(M: int, K: int) -> HarmonizedPanel:
    """Trivial panel when no .bim files are given: all cohorts share the
    same M markers in the same order. (The reference crashes in this case -
    quirks ledger #2; we support it as the natural default for .npy/.npz
    pipelines.)"""
    i_map = np.arange(M, dtype=np.int64)
    return HarmonizedPanel(
        variants=[f"snp{i}" for i in range(M)],
        M=M,
        i_maps=[i_map.copy() for _ in range(K)],
        sources=[np.full(M, k, dtype=np.int64) for k in range(K)],
        missing=[np.empty(0, dtype=np.int64) for _ in range(K)],
    )
