"""Mesh construction and sharding placement for the VAMP state.

The reference's only parallelism is one MPI rank per cohort with the full
MxM LD matrix replicated per rank (reference src/main.py:85,257; per-iteration
pickled bcasts src/sgvamp.py:230-233). Here the device mesh has two named
axes:

  * "cohort" - data parallelism over the K cohorts (maps across
    hosts). The denoiser's cross-cohort combine is a weighted reduction
    over this axis (an XLA psum), replacing the K broadcasts.
  * "shard"  - model parallelism over the marker axis M: the LD matrix is
    block-sharded by rows so each CG matvec is a local block matmul plus an
    all-gather of x. This removes the reference's per-rank
    whole-matrix replication, the cap on M (SURVEY.md section 5).

Shardings are placed on the inputs/state; XLA's sharding propagation
inserts the collectives inside the jitted step.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Sequence

import jax
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

COHORT_AXIS = "cohort"
SHARD_AXIS = "shard"

# 1-D placement convention: arrays at least this long are marker-axis
# vectors (shard), shorter ones are per-cohort scalars (cohort). This is
# safe because K (cohorts, = MPI ranks in the reference) is at most a few
# hundred while production M is >= 10^5; a marker vector SHORTER than the
# threshold merely replicates (correct, just unsharded - the small-M test
# regime). spec_for asserts the K side of the convention.
MARKER_VEC_MIN = 1024


def make_mesh(
    n_cohort: int = 1,
    n_shard: Optional[int] = None,
    devices: Optional[Sequence[jax.Device]] = None,
) -> Mesh:
    """Create a (cohort, shard) mesh over the available devices."""
    devices = list(devices if devices is not None else jax.devices())
    if n_shard is None:
        if len(devices) % n_cohort:
            raise ValueError(
                f"{len(devices)} devices not divisible by cohort axis {n_cohort}"
            )
        n_shard = len(devices) // n_cohort
    arr = np.asarray(devices[: n_cohort * n_shard]).reshape(n_cohort, n_shard)
    return Mesh(arr, (COHORT_AXIS, SHARD_AXIS))


def _put(x, mesh: Mesh, spec: P):
    return jax.device_put(x, NamedSharding(mesh, spec))


def spec_for(shape: tuple, mesh: Mesh) -> P:
    """Sharding spec by array rank/shape convention used throughout:

      (K, M)          -> (cohort, shard)
      (K,)            -> (cohort,)
      (M,)            -> (shard,)
      (K, M, M)       -> (cohort, shard, None)      dense LD: rows sharded
      (K, nb, d, B, B)-> (cohort, shard, None*3)    banded LD: block rows sharded
      scalars / small -> replicated
    """
    ndim = len(shape)
    if ndim == 0:
        return P()
    if ndim == 1:
        # Per-cohort scalar vectors are tiny; marker vectors large (see
        # MARKER_VEC_MIN). A cohort count at/over the threshold would make
        # a (K,) vector shard over markers - fail loudly, not subtly.
        assert mesh.shape[COHORT_AXIS] < MARKER_VEC_MIN, (
            f"cohort axis {mesh.shape[COHORT_AXIS]} >= MARKER_VEC_MIN "
            f"{MARKER_VEC_MIN}: the 1-D placement convention cannot tell "
            f"(K,) from (M,) vectors at this scale")
        return P(SHARD_AXIS) if shape[0] >= MARKER_VEC_MIN else P(COHORT_AXIS)
    if ndim == 2:
        return P(COHORT_AXIS, SHARD_AXIS)
    if ndim == 3:
        return P(COHORT_AXIS, SHARD_AXIS, None)
    return P(COHORT_AXIS, SHARD_AXIS, *([None] * (ndim - 2)))


def shard_inputs(inputs, mesh: Mesh):
    """Place VampInputs on the mesh (see sgvamp.core.vamp.VampInputs)."""
    from sgvamp.core.operators import BlockSparseLD
    from sgvamp.ops.band_kernel import SymBandedLD

    if isinstance(inputs.op, SymBandedLD):
        # the sym matvec runs as a shard_map over the mesh (each device
        # calls the kernel on its own cohorts and block rows; halo and
        # mirror-spill ppermutes cross the marker axis) - it needs the mesh
        # at trace time, so pin it on the operator here
        n_shard = mesh.shape[SHARD_AXIS]
        if inputs.op.nb % n_shard:
            raise ValueError(
                f"sym operator: {inputs.op.nb} block rows not divisible by "
                f"the {n_shard}-way marker-shard axis")
        if inputs.op.nb // n_shard < inputs.op.hb:
            raise ValueError(
                f"sym operator: shard width {inputs.op.nb // n_shard} block "
                f"rows is narrower than the block half-bandwidth "
                f"{inputs.op.hb} - halo/spill exchange only reaches one "
                f"neighbor; use fewer shards, a wider block size, or the "
                f"banded operator")
        inputs = dataclasses.replace(
            inputs, op=dataclasses.replace(inputs.op, mesh=mesh))

    if isinstance(inputs.op, BlockSparseLD):
        # the block list shards over its nnzb axis; pad it to a shard-axis
        # multiple with all-zero blocks (they scatter zeros into row 0 -
        # a no-op) so any pattern size divides evenly
        n_shard = mesh.shape[SHARD_AXIS]
        rem = inputs.op.nnzb % n_shard
        if rem:
            import jax.numpy as jnp
            padn = n_shard - rem
            inputs = dataclasses.replace(
                inputs,
                op=dataclasses.replace(
                    inputs.op,
                    blocks=jnp.pad(inputs.op.blocks,
                                   ((0, 0), (0, padn), (0, 0), (0, 0))),
                    rows=jnp.pad(inputs.op.rows, (0, padn)),
                    cols=jnp.pad(inputs.op.cols, (0, padn)),
                ),
            )

    def place_op_leaf(x):
        # wide-integer leaves are index tables (e.g. BlockSparseLD.rows/
        # cols), not marker data: replicate them. int8 leaves are QUANTIZED
        # BLOCK DATA (SymBandedLD dtype="int8") and must shard like floats.
        if (np.issubdtype(np.dtype(x.dtype), np.integer)
                and np.dtype(x.dtype).itemsize >= 4):
            return _put(x, mesh, P())
        return _put(x, mesh, spec_for(x.shape, mesh))

    op = jax.tree_util.tree_map(place_op_leaf, inputs.op)
    mask = inputs.mask
    if mask is not None:
        mask = _put(mask, mesh, P(SHARD_AXIS))
    pq, plam = inputs.precond_q, inputs.precond_lam
    if pq is not None:
        # preconditioner factorization: block axis = marker axis
        pq = _put(pq, mesh, P(COHORT_AXIS, SHARD_AXIS, None, None))
        plam = _put(plam, mesh, P(COHORT_AXIS, SHARD_AXIS, None))
    return dataclasses.replace(
        inputs,
        op=op,
        r=_put(inputs.r, mesh, P(COHORT_AXIS, SHARD_AXIS)),
        a=_put(inputs.a, mesh, P()),
        N=_put(inputs.N, mesh, P()),
        mask=mask,
        precond_q=pq,
        precond_lam=plam,
    )


def shard_state(state, mesh: Mesh):
    """Place a VampState on the mesh.

    (K, M) arrays shard (cohort, shard); xhat1 (M,) shards over shard only;
    per-cohort scalars and the prior are replicated (they are tiny and feed
    scalar broadcasts).
    """

    def place(x):
        if not hasattr(x, "shape"):
            return x
        if x.ndim == 2:
            return _put(x, mesh, P(COHORT_AXIS, SHARD_AXIS))
        if x.ndim == 1 and x.shape[0] >= MARKER_VEC_MIN:
            return _put(x, mesh, P(SHARD_AXIS))
        return _put(x, mesh, P())

    return jax.tree_util.tree_map(place, state)
