"""Symmetric block-banded LD operator with half storage.

The LD matrix is symmetric, so only the upper-triangle block diagonals
U[i, d] = R[block i, block i+d], d = 0..hb, are stored: (hb+1)/(2hb+1) of
the full band's bytes. int8 storage with one f32 scale per block halves
them again. One matvec computes, for every block row i,

    y_i = sum_{d=0..hb} U[i, d] @ x_{i+d}          (row part)
        + sum_{d=1..hb} U[i-d, d]^T @ x_{i-d}      (mirror part)

Two implementations share that storage:

  * `sym_band_matvec_ref` - plain jax.numpy, left to XLA. It is the
    reference every kernel test compares against and the CPU path.
  * `sym_band_matvec_pallas` - a Pallas kernel on the Triton route for the
    GPU. Pull form: program (i, k) owns block row i of cohort k, reads
    U[i, 0..hb] for the row part and U[i-d, d] for the mirror part, and
    writes y_i alone. No program writes another's output, so there are no
    atomics and the result is deterministic. The mirror blocks were read a
    few programs earlier as row blocks, so their second read comes from L2.
    S right-hand sides make each block a GEMV: f32 multiply-reduce on the
    CUDA cores. int8 blocks reach the kernel as int32 words (a bitcast, no
    copy), unpacked in registers: this keeps the lowering's 32-bit element
    offsets in range past 2 GiB of blocks, and summing a tile's four byte
    planes before each reduction makes it faster than reading bytes.

SymBandedLD.matvec picks the implementation from the backend (gpu: the
compiled kernel, cpu: the reference; any other backend raises). The
Pallas interpreter runs only when asked for by name (impl="interpret").
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Optional

import jax
import jax.numpy as jnp
import numpy as np
from jax import Array
from jax.experimental import pallas as pl
from jax.experimental.pallas import triton as plt

IMPLS = ("reference", "kernel", "interpret")


def _compute_dtype(storage_dtype) -> jnp.dtype:
    """Accumulation dtype: f32 for int8/bf16/f32 storage, f64 for f64."""
    if jnp.dtype(storage_dtype) == jnp.int8:
        return jnp.dtype(jnp.float32)
    return jnp.promote_types(storage_dtype, jnp.float32)


def sym_band_matvec_ref(upper: Array, scales: Optional[Array], x: Array) -> Array:
    """Plain jnp symmetric block-banded matvec.

    upper: (K, nb, hb+1, B, B); scales: (K, nb, hb+1) or None (float
    storage); x: (K, S, nbx*B) with nbx >= nb (a sharded caller appends
    the next shard's halo). Row parts read x blocks i+d < nbx; mirror parts
    pull only from local rows i-d >= 0. Returns (K, S, nb*B).
    """
    K, nb, hbp1, B, _ = upper.shape
    S, nbx = x.shape[1], x.shape[2] // B
    cdt = _compute_dtype(upper.dtype)
    hi = jax.lax.Precision.HIGHEST
    xb = x.astype(cdt).reshape(K, S, nbx, B)
    y = jnp.zeros((K, S, nb, B), cdt)
    for d in range(hbp1):
        n = min(nb, nbx - d)  # rows whose row-part source block exists
        U = upper[:, :n, d].astype(cdt)
        row = jnp.einsum("knpq,ksnq->ksnp", U, xb[:, :, d:d + n], precision=hi)
        if scales is not None:
            row = row * scales[:, None, :n, d, None]
        y = y + jnp.pad(row, ((0, 0), (0, 0), (0, nb - n), (0, 0)))
        if d and nb > d:
            U = upper[:, :nb - d, d].astype(cdt)
            mir = jnp.einsum("knpq,ksnp->ksnq", U, xb[:, :, :nb - d], precision=hi)
            if scales is not None:
                mir = mir * scales[:, None, :nb - d, d, None]
            y = y + jnp.pad(mir, ((0, 0), (0, 0), (d, 0), (0, 0)))
    return y.reshape(K, S, nb * B)


def _mirror_spill(upper: Array, scales: Optional[Array], x: Array) -> Array:
    """(K, S, hb*B): the mirror parts U[j, d]^T x_j of this shard's last hb
    block rows whose target j+d lies past the shard, i.e. on the next
    shard's first hb blocks. x: (K, S, >= nb*B) with local blocks first."""
    K, nb, hbp1, B, _ = upper.shape
    hb, S = hbp1 - 1, x.shape[1]
    cdt = _compute_dtype(upper.dtype)
    xb = x[:, :, :nb * B].astype(cdt).reshape(K, S, nb, B)
    out = jnp.zeros((K, S, hb, B), cdt)
    for d in range(1, hbp1):
        U = upper[:, nb - d:, d].astype(cdt)  # rows j = nb-d..nb-1
        mir = jnp.einsum("knpq,ksnp->ksnq", U, xb[:, :, nb - d:],
                         precision=jax.lax.Precision.HIGHEST)
        if scales is not None:
            mir = mir * scales[:, None, nb - d:, d, None]
        out = out + jnp.pad(mir, ((0, 0), (0, 0), (0, hb - d), (0, 0)))
    return out.reshape(K, S, hb * B)


def _sym_band_kernel(u_ref, sc_ref, x_ref, y_ref, *, hb: int, B: int, S: int,
                     nbx: int, cdt):
    """Program (i, k): y[k, :, block i] from U[k, i, :] and U[k, i-d, d]."""
    i = pl.program_id(0)
    k = pl.program_id(1)
    accs = [jnp.zeros((B,), cdt) for _ in range(S)]

    def xblock(s, j):
        return x_ref[k, s, pl.ds(pl.multiple_of(j * B, B), B)]

    for d in range(hb + 1):  # row part: U[i, d] @ x_{i+d}
        j = jnp.minimum(i + d, nbx - 1)
        w = jnp.where(i + d < nbx, sc_ref[k, i, d], 0.0).astype(cdt)
        tile = u_ref[k, i, d].astype(cdt)
        for s in range(S):
            accs[s] += jnp.sum(tile * xblock(s, j)[None, :], axis=1) * w
    for d in range(1, hb + 1):  # mirror part: U[i-d, d]^T @ x_{i-d}
        j = jnp.maximum(i - d, 0)
        w = jnp.where(i >= d, sc_ref[k, j, d], 0.0).astype(cdt)
        tile = u_ref[k, j, d].astype(cdt)
        for s in range(S):
            accs[s] += jnp.sum(tile * xblock(s, j)[:, None], axis=0) * w
    for s in range(S):
        y_ref[k, s, pl.ds(pl.multiple_of(i * B, B), B)] = accs[s]


def _sym_band_kernel_i8(w_ref, sc_ref, x_ref, y_ref, *, hb: int, B: int, S: int,
                        nbx: int):
    """_sym_band_kernel for int8 blocks read as int32 words.

    Word r of tile row p holds U[p, 4r + j] in byte j. Sub-block (c, j) of
    a tile is rows 4t + c and columns 4r + j (t, r < B/4): one strided load
    of word rows c gives the four sub-blocks (c, 0..3) by shifts. The row
    part sums the products of sub-blocks (c, 0..3) before one reduction
    into output rows 4t + c; the mirror part sums sub-blocks (0..3, j)
    before one reduction into output rows 4r + j. y is stored in that
    order, and the block's scale is folded into its x slices.
    """
    i = pl.program_id(0)
    k = pl.program_id(1)
    Q = B // 4
    f32 = jnp.float32
    accs = [[jnp.zeros((Q,), f32) for _ in range(4)] for _ in range(S)]

    def xsub(s, blk, c, w):  # w * x[blk*B + 4t + c], t = 0..Q-1
        return x_ref[k, s, pl.ds(blk * B + c, Q, stride=4)] * w

    def byte(words, j):  # signed byte j of every word, as f32
        return jnp.right_shift(jnp.left_shift(words, 24 - 8 * j), 24).astype(f32)

    for d in range(hb + 1):  # row part: U[i, d] @ x_{i+d}
        blk = jnp.minimum(i + d, nbx - 1)
        w = jnp.where(i + d < nbx, sc_ref[k, i, d], 0.0)
        xs = [[xsub(s, blk, j, w) for j in range(4)] for s in range(S)]
        for c in range(4):
            words = w_ref[k, i, d, pl.ds(c, Q, stride=4), :]
            bs = [byte(words, j) for j in range(4)]
            for s in range(S):
                prod = bs[0] * xs[s][0][None, :]
                for j in range(1, 4):
                    prod = prod + bs[j] * xs[s][j][None, :]
                accs[s][c] += jnp.sum(prod, axis=1)
    for d in range(1, hb + 1):  # mirror part: U[i-d, d]^T @ x_{i-d}
        src = jnp.maximum(i - d, 0)
        w = jnp.where(i >= d, sc_ref[k, src, d], 0.0)
        xs = [[xsub(s, src, c, w) for c in range(4)] for s in range(S)]
        words = [w_ref[k, src, d, pl.ds(c, Q, stride=4), :] for c in range(4)]
        for j in range(4):
            bs = [byte(words[c], j) for c in range(4)]
            for s in range(S):
                prod = bs[0] * xs[s][0][:, None]
                for c in range(1, 4):
                    prod = prod + bs[c] * xs[s][c][:, None]
                accs[s][j] += jnp.sum(prod, axis=0)
    for s in range(S):
        for c in range(4):
            y_ref[k, s, pl.ds(i * B + c, Q, stride=4)] = accs[s][c]


# Warps per program, measured on an H100 80GB HBM3 at M=524,288, bandwidth
# 256, B=128, int8: the word kernel (700 W limit) 4: 0.169, 8: 0.329
# ms/pass; the element kernel (400 W limit) 2: 0.928, 4: 0.235, 8: 0.400,
# 16: 0.580 ms/pass.
_NUM_WARPS = 4


@functools.partial(jax.jit, static_argnames=("interpret",))
def sym_band_matvec_pallas(upper: Array, scales: Array, x: Array,
                           interpret: bool = False) -> Array:
    """Pallas (Triton route) symmetric block-banded matvec; same contract
    as sym_band_matvec_ref, with scales required (ones for float storage).
    Triton tiles are powers of two, so B must be one."""
    K, nb, hbp1, B, _ = upper.shape
    S, nbx = x.shape[1], x.shape[2] // B
    if B & (B - 1):
        raise ValueError(f"the GPU kernel needs a power-of-two block size, got {B}")
    cdt = _compute_dtype(upper.dtype)
    if upper.dtype == jnp.int8:
        # The Triton lowering indexes an operand of at most 2**32 bytes with
        # signed 32-bit element offsets, which int8 blocks past 2 GiB (K=8
        # cohorts at M=1,048,576, bandwidth 256) overflow. As int32 words
        # every offset stays below 2**30. XLA compiles the view to a
        # bitcast: the blocks are not copied.
        upper = jax.lax.bitcast_convert_type(
            upper.reshape(K, nb, hbp1, B, B // 4, 4), jnp.int32)
        kernel = functools.partial(_sym_band_kernel_i8, hb=hbp1 - 1, B=B, S=S,
                                   nbx=nbx)
    else:
        kernel = functools.partial(_sym_band_kernel, hb=hbp1 - 1, B=B, S=S,
                                   nbx=nbx, cdt=cdt)
    return pl.pallas_call(
        kernel,
        out_shape=jax.ShapeDtypeStruct((K, S, nb * B), cdt),
        grid=(nb, K),
        backend="triton",
        compiler_params=plt.CompilerParams(num_warps=_NUM_WARPS, num_stages=1),
        interpret=interpret,
        name="sym_band_matvec",
    )(upper, scales.astype(jnp.float32), x.astype(cdt))


def _impl_for_backend() -> str:
    backend = jax.default_backend()
    if backend == "gpu":
        return "kernel"
    if backend == "cpu":
        return "reference"
    raise ValueError(f"SymBandedLD has no implementation for backend {backend!r}")


@jax.tree_util.register_dataclass
@dataclasses.dataclass(frozen=True)
class SymBandedLD:
    """Symmetric block-banded LD operator over upper-triangle blocks.

    upper: (K, nb, hb+1, B, B) block diagonals d = 0..hb; the d = 0 block
    is the FULL diagonal block and has no mirror.
    Same matvec contract as the other operators: x is (S*K, M).
    """

    upper: Array
    # (K, nb, hb+1) f32 per-block dequantization scales; set only when
    # upper is int8 (from_band dtype="int8": q = round(U/scale) with
    # scale = max|U|/127).
    scales: Array = None
    s: float = dataclasses.field(default=0.0, metadata=dict(static=True))
    # None picks by backend (gpu: "kernel", cpu: "reference"); tests and
    # measurements name one of IMPLS explicitly.
    impl: Optional[str] = dataclasses.field(default=None,
                                            metadata=dict(static=True))
    # When set (parallel.sharding.shard_inputs pins it), matvec runs as a
    # shard_map over this mesh: cohorts over its cohort axis, block rows
    # over its marker-shard axis (see _matvec_sharded).
    mesh: object = dataclasses.field(default=None, metadata=dict(static=True))

    @property
    def K(self) -> int:
        return self.upper.shape[0]

    @property
    def nb(self) -> int:
        return self.upper.shape[1]

    @property
    def hb(self) -> int:
        return self.upper.shape[2] - 1

    @property
    def B(self) -> int:
        return self.upper.shape[-1]

    @property
    def M(self) -> int:
        return self.nb * self.B

    @property
    def quantized(self) -> bool:
        return self.upper.dtype == jnp.int8

    def bytes_per_pass(self) -> int:
        """Device-memory bytes of LD blocks read by one matvec."""
        n = self.upper.size * self.upper.dtype.itemsize
        if self.scales is not None:
            n += self.scales.size * self.scales.dtype.itemsize
        return n

    def diag_blocks(self) -> Array:
        """(K, nb, B, B) regularized diagonal blocks of Rused (for the
        block-Jacobi preconditioner, core/precond.py)."""
        D = self.upper[:, :, 0].astype(jnp.float32)
        if self.quantized:
            D = D * self.scales[:, :, 0, None, None]
        if self.s != 0.0:
            eye = jnp.eye(self.B, dtype=D.dtype)
            D = (1.0 - self.s) * D + self.s * eye
        return D

    def _local_matvec(self, upper: Array, scales: Optional[Array],
                      x: Array) -> Array:
        impl = self.impl or _impl_for_backend()
        if impl == "reference":
            return sym_band_matvec_ref(upper, scales, x)
        if impl not in IMPLS:
            raise ValueError(f"unknown SymBandedLD impl {impl!r}; one of {IMPLS}")
        if scales is None:
            scales = jnp.ones(upper.shape[:3], jnp.float32)
        return sym_band_matvec_pallas(upper, scales, x,
                                      interpret=impl == "interpret")

    def matvec(self, x: Array) -> Array:
        K = self.K
        S = x.shape[0] // K
        xs = x.reshape(S, K, self.M).transpose(1, 0, 2)  # (K, S, M)
        if self.mesh is not None:
            y = self._matvec_sharded(xs)
        else:
            y = self._local_matvec(self.upper, self.scales, xs)
        y = y.transpose(1, 0, 2).reshape(x.shape).astype(x.dtype)
        if self.s != 0.0:
            y = (1.0 - self.s) * y + self.s * x
        return y

    def _matvec_sharded(self, xs: Array) -> Array:
        """SPMD matvec over the mesh (shard_map): cohorts split over the
        cohort axis, block rows over the marker-shard axis.

        Each shard owns a contiguous run of block rows and the matching
        slice of x. Its row parts need the next shard's first hb x blocks
        (a halo, ppermuted toward lower shard ids). Its first hb rows miss
        the mirror parts from the previous shard's last hb rows: that shard
        computes them as its spill (plain jnp) and ppermutes them toward
        higher shard ids. The wraparound legs carry exact zeros, because
        the upper blocks past the global end are zero.
        """
        from jax.sharding import PartitionSpec as P

        from sgvamp.parallel.sharding import COHORT_AXIS, SHARD_AXIS

        mesh = self.mesh
        n = mesh.shape[SHARD_AXIS]
        hb, B = self.hb, self.B
        right_to_left = [((i + 1) % n, i) for i in range(n)]
        left_to_right = [(i, (i + 1) % n) for i in range(n)]
        quantized = self.quantized

        def local_fn(ub_l, x_l, sc_l):
            sc_l = sc_l if quantized else None
            if hb == 0 or n == 1:
                return self._local_matvec(ub_l, sc_l, x_l)
            halo = jax.lax.ppermute(x_l[:, :, :hb * B], SHARD_AXIS, right_to_left)
            x_ext = jnp.concatenate([x_l, halo], axis=2)
            y_l = self._local_matvec(ub_l, sc_l, x_ext)
            spill = _mirror_spill(ub_l, sc_l, x_l)
            incoming = jax.lax.ppermute(spill, SHARD_AXIS, left_to_right)
            return y_l.at[:, :, :hb * B].add(incoming)

        scales = self.scales
        if scales is None:
            scales = jnp.ones(self.upper.shape[:3], jnp.float32)
        return jax.shard_map(
            local_fn, mesh=mesh,
            in_specs=(P(COHORT_AXIS, SHARD_AXIS, None, None, None),
                      P(COHORT_AXIS, None, SHARD_AXIS),
                      P(COHORT_AXIS, SHARD_AXIS, None)),
            out_specs=P(COHORT_AXIS, None, SHARD_AXIS),
            check_vma=False,
        )(self.upper, xs, scales)

    @staticmethod
    def from_band(band: "np.ndarray", block_size: int, K: int = 1,
                  s: float = 0.0, dtype=None) -> "SymBandedLD":
        """Pack symmetric band storage (M, 2*bw+1) into upper blocks.

        dtype: None keeps the band's dtype, any float dtype casts, "int8"
        quantizes per block. Same padding semantics as BandedLD.from_band
        (identity diagonal on padded markers, callers mask them).
        """
        band = np.asarray(band)
        quantize = dtype in ("int8", np.int8, jnp.int8)
        M, nd_full = band.shape
        bw = (nd_full - 1) // 2
        B = block_size
        got = None
        if quantize and band.dtype == np.float32:
            # native one-pass pack+quantize, bit-identical to the numpy
            # path below (parity-tested), which moves ~5 GB of float
            # temporaries at M=512k
            from sgvamp import native as _native

            got = _native.band_pack_i8(band, B)
        if got is None:
            got = _pack_upper(band, B, bw, quantize,
                              np.float32 if quantize else (dtype or band.dtype))
        upper, scales = got
        stacked = upper[None] if K == 1 else np.repeat(upper[None], K, axis=0)
        sc_stacked = None
        if scales is not None:
            sc_stacked = jnp.asarray(
                scales[None] if K == 1 else np.repeat(scales[None], K, axis=0))
        return SymBandedLD(upper=jnp.asarray(stacked), scales=sc_stacked, s=s)

    def to_dense(self) -> Array:
        """Materialize (K, M, M) - tests only."""
        K, nb, hbp1, B = self.K, self.nb, self.hb + 1, self.B
        up = np.asarray(self.upper)
        if self.quantized:
            up = up.astype(np.float32) * np.asarray(self.scales)[..., None, None]
        out = np.zeros((K, self.M, self.M), dtype=up.dtype)
        for k in range(K):
            for i in range(nb):
                for d in range(hbp1):
                    j = i + d
                    if j < nb:
                        blk = up[k, i, d]
                        out[k, i * B:(i + 1) * B, j * B:(j + 1) * B] += blk
                        if d > 0:
                            out[k, j * B:(j + 1) * B, i * B:(i + 1) * B] += blk.T
        eye = np.eye(self.M, dtype=out.dtype)
        return jnp.asarray((1.0 - self.s) * out + self.s * eye[None])


def _pack_upper(band: np.ndarray, B: int, bw: int, quantize: bool, out_dtype):
    """numpy pack of band storage into (nb, hb+1, B, B) upper blocks (and
    (nb, hb+1) int8 scales when quantizing)."""
    M, nd_full = band.shape
    pad = (-M) % B
    if pad:
        ext = np.zeros((pad, nd_full), dtype=band.dtype)
        ext[:, bw] = 1.0
        band = np.concatenate([band, ext], axis=0)
        M = M + pad
    nb = M // B
    hb = -(-bw // B)
    band_r = band.reshape(nb, B, nd_full)
    upper = np.zeros((nb, hb + 1, B, B), dtype=out_dtype)
    p = np.arange(B)[:, None]
    q = np.arange(B)[None, :]
    for d in range(hb + 1):
        col = bw + d * B + q - p
        valid = (col >= 0) & (col < nd_full)
        colc = np.clip(col, 0, nd_full - 1)
        vals = np.take_along_axis(band_r, colc[None, :, :], axis=2)
        upper[:, d] = np.where(valid[None], vals, 0.0)
    # Invariant: blocks whose columns run past the matrix are exactly zero
    # (band storage guarantees it for real data; enforce it so the matvecs
    # need no edge masking and sharded wraparound legs carry zeros).
    for d in range(1, hb + 1):
        upper[nb - d:, d] = 0.0
    if not quantize:
        return upper, None
    # symmetric per-block quantization: every block's worst-case error is
    # scale/2; zero blocks get scale 0 and dequantize exactly
    sc = np.abs(upper).max(axis=(-2, -1)) / 127.0
    safe = np.where(sc == 0.0, 1.0, sc)
    q8 = np.clip(np.rint(upper / safe[..., None, None]), -127, 127).astype(np.int8)
    return q8, sc.astype(np.float32)
