"""LD-matrix operators: the framework's hot compute path.

The reference keeps the LD matrix as a scipy CSR per MPI rank and relies on
scipy's sparse matvec (reference src/main.py:257, src/sgvamp.py:316,332).
Accelerators want dense, tiled, batched contractions instead, so the operator
abstraction here exposes a *batched* matvec over the K-cohort axis:

  matvec: (K, M) -> (K, M),  row k computes R_k @ x_k

Implementations:
  * DenseLD  - (K, M, M) dense stack; one einsum -> batched matmul.
               Under a mesh, R is sharded (cohort, shard, None) and x
               (cohort, shard); XLA all-gathers x over the shard axis and
               the matvec becomes a local block matmul (HBM-roofline bound).
  * BandedLD - block-banded storage (K, nb, 2*hb+1, B, B): only diagonal
               blocks within a bandwidth are kept, the accelerator-friendly
               equivalent of the reference's CSR sparsity for banded
               genomic LD. matvec is a batched (B, B) x (B,) block contraction.

All operators carry the `(1-s)*R + s*I` regularization as a scalar pair
(reference src/main.py:265) folded into the matvec rather than materialized.

float32 contractions pass precision=HIGHEST: the GPU would otherwise run
them in TF32 (about three decimal digits, coarser than int8 LD storage).
That makes a float32 operator slower than TF32 would; the fast paths
store bfloat16 or int8 blocks, whose contractions it does not affect.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import jax
import jax.numpy as jnp
import numpy as np
from jax import Array


def _precision(*dtypes):
    """HIGHEST for a float32 contraction, None (exact or bf16) otherwise."""
    if jnp.result_type(*dtypes) == jnp.float32:
        return jax.lax.Precision.HIGHEST
    return None


def _regularize(y: Array, x: Array, s: float) -> Array:
    # Rused @ x = (1-s) * (R @ x) + s * x   (reference src/main.py:265, folded)
    if s == 0.0:
        return y
    return (1.0 - s) * y + s * x


def _regularize_diag(D: Array, s: float) -> Array:
    # diagonal blocks of Rused = (1-s) R + s I, from diagonal blocks of R
    if s == 0.0:
        return D
    eye = jnp.eye(D.shape[-1], dtype=D.dtype)
    return (1.0 - s) * D + s * eye


@jax.tree_util.register_dataclass
@dataclasses.dataclass(frozen=True)
class DenseLD:
    """Dense stacked LD operator.

    Attributes:
      mats: (K, M, M) dense LD matrices (one per cohort).
      s:    regularization weight in Rused = (1-s) R + s I.
      accum_dtype: accumulation dtype for the matvec (use float32 when
        `mats` is bfloat16 so the product accumulates in fp32).
    """

    mats: Array
    s: float = dataclasses.field(default=0.0, metadata=dict(static=True))
    accum_dtype: str = dataclasses.field(default="", metadata=dict(static=True))

    @property
    def K(self) -> int:
        return self.mats.shape[0]

    @property
    def M(self) -> int:
        return self.mats.shape[-1]

    def bytes_per_pass(self) -> int:
        """HBM bytes of LD data read by one matvec (roofline accounting)."""
        return self.mats.size * self.mats.dtype.itemsize

    def matvec(self, x: Array) -> Array:
        """R @ x rowwise. x: (S*K, M) - S>=1 independent right-hand sides
        per cohort, stacked along the leading axis; one fused pass over
        the matrix serves all of them (the multi-RHS trick that halves
        HBM traffic when the two CG solves of a VAMP iteration share A)."""
        pet = jnp.dtype(self.accum_dtype) if self.accum_dtype else None
        S = x.shape[0] // self.K
        xs = x.reshape(S, self.K, self.M).astype(self.mats.dtype)
        y = jnp.einsum("kij,skj->ski", self.mats, xs,
                       preferred_element_type=pet,
                       precision=_precision(self.mats.dtype))
        return _regularize(y.reshape(x.shape).astype(x.dtype), x, self.s)

    def to_dense(self) -> Array:
        eye = jnp.eye(self.M, dtype=self.mats.dtype)
        return (1.0 - self.s) * self.mats + self.s * eye[None]

    def diag_blocks(self, block_size: int = 0) -> Array:
        """(K, nb, B, B) regularized diagonal blocks of Rused (for the
        block-Jacobi preconditioner, core/precond.py). Default block:
        the largest divisor of M at most 256."""
        B = block_size or max(b for b in range(1, min(256, self.M) + 1)
                              if self.M % b == 0)
        if self.M % B:
            raise ValueError(f"M={self.M} not a multiple of block {B}")
        nb = self.M // B
        Dv = self.mats.reshape(self.K, nb, B, nb, B)
        D = jnp.moveaxis(jnp.diagonal(Dv, axis1=1, axis2=3), -1, 1)
        return _regularize_diag(D.astype(jnp.float32), self.s)


@jax.tree_util.register_dataclass
@dataclasses.dataclass(frozen=True)
class BandedLD:
    """Block-banded LD operator.

    Genomic LD decays with base-pair distance, so R is effectively banded.
    Storage keeps, for each of `nb = M/B` block rows, the `2*hb + 1`
    diagonal-adjacent (B, B) blocks (zero-padded at the edges):

      blocks[k, i, d] = R_k[i*B:(i+1)*B, (i+d-hb)*B:(i+d-hb+1)*B]

    matvec gathers the needed x blocks and contracts with one batched
    matmul of shape (K*nb*(2hb+1), B, B) @ (..., B) - matmul-shaped work with
    O(M * B * (2hb+1)) FLOPs instead of O(M^2).

    Attributes:
      blocks: (K, nb, 2*hb+1, B, B)
      s: regularization weight (folded into matvec).
    """

    blocks: Array
    s: float = dataclasses.field(default=0.0, metadata=dict(static=True))
    accum_dtype: str = dataclasses.field(default="", metadata=dict(static=True))

    @property
    def K(self) -> int:
        return self.blocks.shape[0]

    @property
    def nb(self) -> int:
        return self.blocks.shape[1]

    @property
    def hb(self) -> int:
        return (self.blocks.shape[2] - 1) // 2

    @property
    def B(self) -> int:
        return self.blocks.shape[-1]

    @property
    def M(self) -> int:
        return self.nb * self.B

    def bytes_per_pass(self) -> int:
        """HBM bytes of LD blocks read by one matvec (roofline accounting)."""
        return self.blocks.size * self.blocks.dtype.itemsize

    def diag_blocks(self) -> Array:
        """(K, nb, B, B) regularized diagonal blocks of Rused (for the
        block-Jacobi preconditioner, core/precond.py)."""
        return _regularize_diag(self.blocks[:, :, self.hb].astype(jnp.float32),
                                self.s)

    def matvec(self, x: Array) -> Array:
        """R @ x rowwise; x may stack S right-hand sides per cohort along
        the leading axis ((S*K, M)) - one fused pass serves all."""
        K, nb, nd, B = self.K, self.nb, 2 * self.hb + 1, self.B
        hb = self.hb
        S = x.shape[0] // K
        xb = x.reshape(S, K, nb, B).astype(self.blocks.dtype)
        # Neighbor block table: for block row i, columns i-hb .. i+hb.
        # Build by shifting the block axis; out-of-range neighbors are zero
        # (matching the zero-padded edge blocks).
        shifted = []
        for d in range(-hb, hb + 1):
            shifted.append(_shift_blocks(xb, d))
        xn = jnp.stack(shifted, axis=3)  # (S, K, nb, nd, B)
        pet = jnp.dtype(self.accum_dtype) if self.accum_dtype else None
        yb = jnp.einsum("kndij,skndj->skni", self.blocks, xn,
                        preferred_element_type=pet,
                        precision=_precision(self.blocks.dtype))
        y = yb.reshape(x.shape).astype(x.dtype)
        return _regularize(y, x, self.s)

    def to_dense(self) -> Array:
        """Materialize dense (K, M, M) - for tests only."""
        K, nb, B, hb = self.K, self.nb, self.B, self.hb
        out = np.zeros((K, self.M, self.M), dtype=np.asarray(self.blocks).dtype)
        blocks = np.asarray(self.blocks)
        for k in range(K):
            for i in range(nb):
                for d in range(2 * hb + 1):
                    j = i + d - hb
                    if 0 <= j < nb:
                        out[k, i * B:(i + 1) * B, j * B:(j + 1) * B] = blocks[k, i, d]
        eye = np.eye(self.M, dtype=out.dtype)
        return jnp.asarray((1.0 - self.s) * out + self.s * eye[None])

    @staticmethod
    def from_band(band: "np.ndarray", block_size: int, K: int = 1,
                  s: float = 0.0, dtype=None) -> "BandedLD":
        """Pack symmetric band storage (M, 2*bw+1) into block-banded form
        without materializing MxM (the large-M path used by bench/sim).

        band[i, bw + d] = R[i, i+d]. M is padded up to a block multiple
        with identity rows (callers mask padded markers via VampInputs.mask).
        """
        band = np.asarray(band)
        M, nd = band.shape
        bw = (nd - 1) // 2
        B = block_size
        pad = (-M) % B
        if pad:
            ext = np.zeros((pad, nd), dtype=band.dtype)
            ext[:, bw] = 1.0
            band = np.concatenate([band, ext], axis=0)
            M = M + pad
        nb = M // B
        hb = -(-bw // B)  # block half-bandwidth
        band_r = band.reshape(nb, B, nd)
        out_dtype = np.dtype(dtype) if dtype is not None else band.dtype
        blocks = np.zeros((nb, 2 * hb + 1, B, B), dtype=out_dtype)
        p = np.arange(B)[:, None]
        q = np.arange(B)[None, :]
        for d in range(2 * hb + 1):
            off0 = (d - hb) * B
            col = bw + off0 + q - p           # (B, B) band-column index
            valid = (col >= 0) & (col < nd)
            colc = np.clip(col, 0, nd - 1)
            vals = np.take_along_axis(band_r, colc[None, :, :], axis=2)
            blocks[:, d] = np.where(valid[None], vals, 0.0)
        stacked = blocks[None] if K == 1 else np.repeat(blocks[None], K, axis=0)
        return BandedLD(blocks=jnp.asarray(stacked), s=s,
                        accum_dtype="float32" if out_dtype != np.float64 else "")

    @staticmethod
    def from_dense(mats: Array, block_size: int, bandwidth_blocks: int,
                   s: float = 0.0, dtype=None) -> "BandedLD":
        """Pack a dense (K, M, M) stack into block-banded storage.

        Entries outside the band are dropped (caller chooses a bandwidth
        that captures the LD support).
        """
        mats = np.asarray(mats)
        K, M, _ = mats.shape
        B, hb = block_size, bandwidth_blocks
        if M % B:
            raise ValueError(f"M={M} must be a multiple of block_size={B}")
        nb = M // B
        out = np.zeros((K, nb, 2 * hb + 1, B, B), dtype=dtype or mats.dtype)
        for i in range(nb):
            for d in range(2 * hb + 1):
                j = i + d - hb
                if 0 <= j < nb:
                    out[:, i, d] = mats[:, i * B:(i + 1) * B, j * B:(j + 1) * B]
        return BandedLD(blocks=jnp.asarray(out), s=s,
                        accum_dtype="" if out.dtype == np.float64 else "float32")


@jax.tree_util.register_dataclass
@dataclasses.dataclass(frozen=True)
class BlockSparseLD:
    """Block-sparse LD operator: arbitrary (B, B) block coordinates.

    The reference's CSR path holds ANY sparsity pattern - including
    long-range LD (trans effects, inversions) far off the diagonal
    (reference src/main.py:251-257). BandedLD drops such entries; this
    operator keeps them as scattered dense blocks, the accelerator-friendly
    middle ground between banded storage and an O(M^2) dense stack:
    only B x B tiles containing at least one nonzero are stored.

    Storage (block coordinates shared across cohorts as the union of the
    K patterns; cohorts lacking a block hold zeros there so the matvec
    stays one batched einsum):

      blocks: (K, nnzb, B, B)   dense tiles
      rows:   (nnzb,) int32     block-row index of each tile
      cols:   (nnzb,) int32     block-col index of each tile

    matvec is gather (x blocks by `cols`) -> batched (B, B) @ (B,)
    contraction -> scatter-add (by `rows`): matmul-shaped work of
    O(nnzb * B^2) FLOPs regardless of where the blocks sit.
    """

    blocks: Array
    rows: Array
    cols: Array
    nb: int = dataclasses.field(metadata=dict(static=True))
    s: float = dataclasses.field(default=0.0, metadata=dict(static=True))
    accum_dtype: str = dataclasses.field(default="", metadata=dict(static=True))

    @property
    def K(self) -> int:
        return self.blocks.shape[0]

    @property
    def nnzb(self) -> int:
        return self.blocks.shape[1]

    @property
    def B(self) -> int:
        return self.blocks.shape[-1]

    @property
    def M(self) -> int:
        return self.nb * self.B

    def bytes_per_pass(self) -> int:
        """HBM bytes of LD blocks read by one matvec (roofline accounting)."""
        return self.blocks.size * self.blocks.dtype.itemsize

    def diag_blocks(self) -> Array:
        """(K, nb, B, B) regularized diagonal blocks of Rused (for the
        block-Jacobi preconditioner, core/precond.py).

        from_csr guarantees every diagonal block is stored; slots are in
        ascending (row, col) key order, so the first nb hits of rows==cols
        are the nb diagonal blocks in block-row order (shard-padding slots
        with rows=cols=0 sort after all real slots and are never taken).
        """
        slots = jnp.nonzero(self.rows == self.cols, size=self.nb)[0]
        D = jnp.take(self.blocks, slots, axis=1).astype(jnp.float32)
        return _regularize_diag(D, self.s)

    def matvec(self, x: Array) -> Array:
        """R @ x rowwise; x may stack S right-hand sides per cohort along
        the leading axis ((S*K, M)) - one fused pass serves all."""
        K, nb, B = self.K, self.nb, self.B
        S = x.shape[0] // K
        xb = x.reshape(S, K, nb, B).astype(self.blocks.dtype)
        xn = jnp.take(xb, self.cols, axis=2)            # (S, K, nnzb, B)
        pet = jnp.dtype(self.accum_dtype) if self.accum_dtype else None
        yn = jnp.einsum("knij,sknj->skni", self.blocks, xn,
                        preferred_element_type=pet,
                        precision=_precision(self.blocks.dtype))
        acc_dt = yn.dtype
        yb = jnp.zeros((S, K, nb, B), acc_dt).at[:, :, self.rows].add(yn)
        y = yb.reshape(x.shape).astype(x.dtype)
        return _regularize(y, x, self.s)

    def to_dense(self) -> Array:
        """Materialize dense (K, M, M) - for tests only."""
        K, nb, B = self.K, self.nb, self.B
        out = np.zeros((K, self.M, self.M), dtype=np.asarray(self.blocks).dtype)
        blocks = np.asarray(self.blocks)
        rows = np.asarray(self.rows)
        cols = np.asarray(self.cols)
        for n in range(self.nnzb):
            i, j = int(rows[n]), int(cols[n])
            out[:, i * B:(i + 1) * B, j * B:(j + 1) * B] = blocks[:, n]
        eye = np.eye(self.M, dtype=out.dtype)
        return jnp.asarray((1.0 - self.s) * out + self.s * eye[None])

    @staticmethod
    def from_csr(Rs, block_size: int, s: float = 0.0, dtype=None,
                 M: Optional[int] = None) -> "BlockSparseLD":
        """Build from K scipy CSR/COO matrices without densifying M x M.

        The block pattern is the union over cohorts, plus every diagonal
        block (the unit diagonal / identity padding keeps A = gamw R +
        gam2 I well-conditioned on padded markers).
        """
        import scipy.sparse

        Rs = [R.tocoo() for R in Rs]
        K = len(Rs)
        if M is None:
            M = Rs[0].shape[0]
        B = block_size
        pad = (-M) % B
        Mp = M + pad
        nb = Mp // B

        # union pattern (always include the diagonal blocks)
        keys = [np.arange(nb, dtype=np.int64) * nb + np.arange(nb)]
        for R in Rs:
            keys.append((R.row // B).astype(np.int64) * nb + (R.col // B))
        uniq = np.unique(np.concatenate(keys))
        rows = (uniq // nb).astype(np.int32)
        cols = (uniq % nb).astype(np.int32)
        nnzb = uniq.shape[0]

        out_dtype = np.dtype(dtype) if dtype is not None else np.asarray(Rs[0].data).dtype
        blocks = np.zeros((K, nnzb, B, B), out_dtype)
        for k, R in enumerate(Rs):
            key = (R.row // B).astype(np.int64) * nb + (R.col // B)
            slot = np.searchsorted(uniq, key)
            blocks[k, slot, R.row % B, R.col % B] = R.data
        if pad:
            # identity diagonal on padded markers (mask excludes them from
            # all statistics; this only keeps the operator SPD)
            dslot = np.searchsorted(uniq, np.arange(nb) * np.int64(nb) + np.arange(nb))
            last = nb - 1
            for p in range(pad):
                idx = M + p
                blocks[:, dslot[idx // B], idx % B, idx % B] = 1.0
        return BlockSparseLD(
            blocks=jnp.asarray(blocks), rows=jnp.asarray(rows),
            cols=jnp.asarray(cols), nb=nb, s=s,
            accum_dtype="" if out_dtype == np.float64 else "float32",
        )


def _shift_blocks(xb: Array, d: int) -> Array:
    """Shift (..., nb, B) along the block axis by d, zero-filling the edge."""
    if d == 0:
        return xb
    nb = xb.shape[-2]
    if abs(d) >= nb:
        return jnp.zeros_like(xb)
    lead = [(0, 0)] * (xb.ndim - 2)
    if d > 0:
        return jnp.pad(xb[..., d:, :], lead + [(0, d), (0, 0)])
    return jnp.pad(xb[..., :d, :], lead + [(-d, 0), (0, 0)])
