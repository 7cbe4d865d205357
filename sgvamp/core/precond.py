"""Block-Jacobi preconditioner for the LMMSE conjugate-gradient solves.

The VAMP iteration is ~100% LD-matvec bound: each CG iteration streams the
whole LD block array through HBM once, so the only lever beyond roofline
bandwidth is FEWER CG iterations. The reference has no preconditioner at
all (its scipy cg calls are plain, reference src/sgvamp.py:316,332); a
block-Jacobi preconditioner beats it outright on time-to-tolerance.

Per VAMP iteration the system is A_k = gamw_k * Rused_k + gam2_k * I with
fresh scalars (gamw, gam2), so the preconditioner is rebuilt inside the
jitted step: take the (K, nb, B, B) diagonal blocks of Rused (each operator
exposes them via diag_blocks()), optionally restrict to P x P diagonal
sub-blocks (P = sub_block <= B divides storage and per-CG-iteration HBM
traffic by B/P), shift by gam2, and invert as one batched jnp.linalg.inv,
amortized over ~10-100 CG iterations.

Applying M^{-1} is a batched (P, P) x (P, S) matmul reading M*P*itemsize
bytes - at P=64/bfloat16 that is ~12% of one bf16 LD pass at bandwidth 256,
so the preconditioner pays for itself as soon as it saves one CG iteration
in eight.

Genomic LD concentrates near the diagonal (the same fact that makes banded
storage work), so the block diagonal captures most of A's structure and
measured iteration counts at cg_rtol=1e-5 drop ~2x (see bench.py A/B).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
from jax import Array


def block_jacobi_inverse(op, gamw: Array, gam2: Array, sub_block: int = 0,
                         dtype=jnp.float32, setup_chunk: int = 2048) -> Array:
    """Inverse diagonal P x P blocks of A = gamw * Rused + gam2 * I.

    Args:
      op: an LD operator exposing diag_blocks() -> (K, nb, B, B) regularized
        diagonal blocks of Rused.
      gamw, gam2: (K,) per-cohort scalars of this VAMP iteration.
      sub_block: P, the preconditioner block size; 0 or B uses the full
        storage block, any divisor of B restricts to the P x P diagonal
        sub-blocks (less HBM traffic per apply, weaker preconditioner).
      dtype: storage dtype of the inverse blocks (bfloat16 halves apply
        traffic; the preconditioner only steers CG, so low precision is
        safe - A itself stays exact).
      setup_chunk: cap on how many P x P shift+invert problems run per
        lax.map step. The K*M/P inversions are independent; one batched
        jnp.linalg.inv over all of them holds LU temporaries for every
        block at once (gigabytes at K=8 x M=1M). Chunking bounds the
        temp to O(setup_chunk * P^2) (~32 MB at the default) while each
        chunk is still a large batch. 0 disables chunking (single
        batched inv).

    Returns:
      (K, M // P, P, P) inverse blocks.
    """
    D = _extract_sub_blocks(op, sub_block)
    K, nbp, P, _ = D.shape
    eye = jnp.eye(P, dtype=D.dtype)
    total = K * nbp

    def _shift_invert(d, w, s):
        A = w[..., None, None] * d + s[..., None, None] * eye
        inv = jnp.linalg.inv(A)
        # inv of SPD is SPD; symmetrize away LU rounding asymmetry so CG's
        # implicit M^{-1}-inner-product stays an inner product.
        return (0.5 * (inv + jnp.swapaxes(inv, -1, -2))).astype(dtype)

    if not setup_chunk or total <= setup_chunk:
        return _shift_invert(D, gamw[:, None], gam2[:, None])

    # Chunked path: flatten the (K, nbp) batch and lax.map the
    # shift+invert over chunk groups (padding with identity problems:
    # w=0, s=1 -> inv(I) = I, no NaNs) so only one chunk's LU
    # temporaries are ever live.
    Pinv = _chunked_map(
        lambda args: _shift_invert(*args),
        (D.reshape(total, P, P), jnp.repeat(gamw, nbp),
         jnp.repeat(gam2, nbp)),
        (eye, 0.0, 1.0), setup_chunk)
    return Pinv.reshape(K, nbp, P, P)


def _chunked_map(fn, leaves, pad_values, chunk):
    """lax.map `fn` over chunk-sized groups of the leaves' leading axis.

    All three preconditioner stages (shift+invert, eigh, rebuild) batch
    over K*M/P independent P x P problems whose one-shot temporaries OOM
    the chip at biobank scale; this is their shared scaffolding. Each
    leaf is padded to a chunk multiple with its pad_value (a scalar or an
    array broadcastable to the leaf's trailing shape - pads are chosen so
    fn stays NaN-free on them), fn maps a tuple of (chunk, ...) slices to
    a pytree of (chunk, ...) outputs, and outputs are unpadded back to
    the true length.
    """
    total = leaves[0].shape[0]
    pad = (-total) % chunk
    if pad:
        leaves = tuple(
            jnp.concatenate(
                [x, jnp.broadcast_to(jnp.asarray(v, x.dtype),
                                     (pad,) + x.shape[1:])], axis=0)
            for x, v in zip(leaves, pad_values))
    G = leaves[0].shape[0] // chunk
    out = jax.lax.map(
        fn, tuple(x.reshape(G, chunk, *x.shape[1:]) for x in leaves))
    return jax.tree_util.tree_map(
        lambda y: y.reshape(G * chunk, *y.shape[2:])[:total], out)


def _extract_sub_blocks(op, sub_block: int) -> Array:
    """(K, M/P, P, P) diagonal P x P sub-blocks of Rused (shared by the
    direct and eigendecomposition setup paths)."""
    D = op.diag_blocks()  # (K, nb, B, B)
    K, nb, B, _ = D.shape
    P = sub_block or B
    if B % P:
        raise ValueError(f"sub_block={P} must divide the storage block {B}")
    if P < B:
        ns = B // P
        Dv = D.reshape(K, nb, ns, P, ns, P)
        D = jnp.moveaxis(jnp.diagonal(Dv, axis1=2, axis2=4), -1, 2)
        D = D.reshape(K, nb * ns, P, P)
    else:
        D = D.reshape(K, nb, P, P)
    return D


def block_jacobi_eig(op, sub_block: int = 0, setup_chunk: int = 2048,
                     dtype=None) -> tuple[Array, Array]:
    """One-time eigendecomposition of the diagonal sub-blocks: D = Q L Q^T.

    The per-VAMP-iteration system is A = gamw * Rused + gam2 * I with
    FRESH scalars each iteration, but the scalars enter the block inverse
    only through the eigenvalues:

        inv(gamw * D + gam2 * I) = Q diag(1/(gamw * l + gam2)) Q^T.

    So factorizing once per run turns every iteration's rebuild into two
    batched matmuls instead of a batched LU inversion; the eigh itself
    runs once, amortized across all iterations of the run. Which of the
    two setups is cheaper on the GPU is not measured yet.

    Returns (Q, lam): (K, M/P, P, P) eigenvectors stored at `dtype`
    (default: the block dtype; pass the preconditioner dtype - bf16
    halves/quarters the cache's HBM residency at the ceiling, and the
    preconditioner only steers CG), (K, M/P, P) eigenvalues at the
    blocks' native dtype (they are tiny; full precision keeps the f64
    preconditioner exactly f64).
    """
    D = _extract_sub_blocks(op, sub_block)
    K, nbp, P, _ = D.shape
    total = K * nbp
    qdt = jnp.dtype(dtype) if dtype is not None else D.dtype

    if not setup_chunk or total <= setup_chunk:
        lam, Q = jnp.linalg.eigh(D)
        return Q.astype(qdt), lam

    # cast Q inside the map so only one chunk's full-precision
    # eigenvectors are ever live
    lam, Q = _chunked_map(
        lambda args: (lambda w_q: (w_q[0], w_q[1].astype(qdt)))(
            jnp.linalg.eigh(args[0])),
        (D.reshape(total, P, P),), (jnp.eye(P, dtype=D.dtype),),
        setup_chunk)
    return Q.reshape(K, nbp, P, P), lam.reshape(K, nbp, P)


def block_jacobi_from_eig(Q: Array, lam: Array, gamw: Array, gam2: Array,
                          dtype=jnp.float32, chunk: int = 2048) -> Array:
    """Per-iteration inverse blocks from the cached factorization:
    Pinv = Q diag(1/(gamw*lam + gam2)) Q^T - exact for the shifted system
    (up to Q's storage precision), symmetric by construction, two batched
    matmuls. Chunked with lax.map so the f32 einsum temporaries never
    exceed O(chunk * P^2) at biobank scale."""
    K, nbp, P, _ = Q.shape
    # the shift happens at lam's native precision (f64 eigenvalues under
    # an f64 preconditioner stay f64); only the final product drops to
    # Q's storage dtype
    c = (1.0 / (gamw[:, None, None] * lam
                + gam2[:, None, None])).astype(Q.dtype)
    total = K * nbp
    if not chunk or total <= chunk:
        Pinv = jnp.einsum("knpi,kni,knqi->knpq", Q, c, Q,
                          preferred_element_type=jnp.float32)
        return Pinv.astype(dtype)
    Pinv = _chunked_map(
        lambda args: jnp.einsum("npi,ni,nqi->npq", args[0], args[1], args[0],
                                preferred_element_type=jnp.float32
                                ).astype(dtype),
        (Q.reshape(total, P, P), c.reshape(total, P)), (0.0, 1.0), chunk)
    return Pinv.reshape(K, nbp, P, P)


def apply_block_jacobi(Pinv: Array, v: Array) -> Array:
    """z = blockdiag(Pinv) @ v, batched over lanes.

    v: (L, M) with L a multiple of K (the fused multi-RHS CG stacks
    lane groups that share per-cohort systems, e.g. L = 2K).
    """
    K, nbp, P, _ = Pinv.shape
    L, M = v.shape
    C = L // K
    vb = v.reshape(C, K, nbp, P)
    # keep v at its own precision; a bfloat16 Pinv only loses precision on
    # the already-approximate preconditioner side. Default matmul precision
    # (TF32 on a GPU) on purpose: the preconditioner only steers CG, and
    # HIGHEST made this apply 2.7-6.8x slower on an H100.
    z = jnp.einsum("knpq,cknq->cknp", Pinv, vb,
                   preferred_element_type=jnp.promote_types(v.dtype,
                                                            jnp.float32))
    return z.reshape(L, M).astype(v.dtype)
