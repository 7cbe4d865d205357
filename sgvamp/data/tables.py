"""Whitespace-delimited text tables (PLINK .linear, .ld, .bim) read with
the standard library: the same values as the reference's pandas readers
(read_table on whitespace), without pandas on the engine's path."""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence

import numpy as np

# fields pandas' read_table parses as missing
NA = frozenset({"", "NA", "N/A", "n/a", "NULL", "null", "None", "<NA>", "#N/A",
                "#N/A N/A", "#NA", "nan", "NaN", "-nan", "-NaN"})


def read_rows(path: str) -> List[List[str]]:
    """Non-blank lines split on whitespace."""
    with open(path) as f:
        return [fields for fields in (line.split() for line in f) if fields]


def read_columns(path: str, names: Optional[Sequence[str]] = None
                 ) -> Dict[str, List[str]]:
    """Columns of a table whose first row is its header (all of them, or
    the named ones), as lists of string fields."""
    rows = read_rows(path)
    header, body = rows[0], rows[1:]
    index = {name: i for i, name in enumerate(header)}
    return {name: [r[index[name]] for r in body] for name in (names or header)}


def to_float(fields: Sequence[str]) -> np.ndarray:
    """float64 array of string fields, missing markers as NaN."""
    return np.asarray([np.nan if v in NA else float(v) for v in fields],
                      dtype=np.float64)
