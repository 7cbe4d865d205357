"""PLINK-to-numpy conversion CLI (reference scripts/plink2np.py behavior)."""

from __future__ import annotations

import argparse
import sys
from typing import List, Optional

from sgvamp.data.plink import ld_to_npz, linear_to_npy


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description="Convert PLINK .ld/.linear to numpy")
    p.add_argument("-ld_file", "--ld-file", help="Path to .ld file", default=None)
    p.add_argument("-r_file", "--r-file", help="Path to .assoc.linear file", default=None)
    return p


def main(argv: Optional[List[str]] = None) -> int:
    args = build_parser().parse_args(argv)
    if args.r_file:
        out_r, r = linear_to_npy(args.r_file)
        print(f"r vector ({len(r)} markers) -> {out_r}")
    if args.ld_file:
        if not args.r_file:
            raise SystemExit("--ld-file conversion needs --r-file for SNP indexing")
        out_R = ld_to_npz(args.ld_file, args.r_file)
        print(f"R matrix -> {out_R}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
