"""LD operator tests: dense and block-banded matvec equivalence."""

import jax.numpy as jnp
import numpy as np
import pytest

from sgvamp.core.operators import BandedLD, DenseLD


def _banded_dense(rng, K, M, band):
    A = rng.normal(size=(K, M, M))
    A = (A + A.transpose(0, 2, 1)) / 2
    i, j = np.indices((M, M))
    A[:, np.abs(i - j) > band] = 0.0
    return A


def test_dense_matvec_and_regularization():
    rng = np.random.default_rng(0)
    K, M = 2, 48
    R = rng.normal(size=(K, M, M))
    x = rng.normal(size=(K, M))
    op = DenseLD(mats=jnp.asarray(R), s=0.3)
    want = 0.7 * np.einsum("kij,kj->ki", R, x) + 0.3 * x
    np.testing.assert_allclose(np.asarray(op.matvec(jnp.asarray(x))), want, rtol=1e-12)
    np.testing.assert_allclose(np.asarray(op.to_dense()),
                               0.7 * R + 0.3 * np.eye(M)[None], rtol=1e-12)


@pytest.mark.parametrize("B,hb", [(8, 1), (8, 2), (16, 3)])
def test_banded_matches_dense(B, hb):
    rng = np.random.default_rng(1)
    K, M = 2, 96
    # Band narrow enough to be fully captured: entries within (hb*B - ?) of
    # the diagonal. Block row i covers columns (i-hb)B..(i+hb+1)B, so any
    # band <= (hb)*B ... use band = (hb - 0) * B - 1 to be safe? Blocks
    # capture |i_blk - j_blk| <= hb, i.e. element band up to hb*B at block
    # boundaries. Use element band (hb-0)*B and verify via to_dense instead.
    band = hb * B
    R = _banded_dense(rng, K, M, band)
    op = BandedLD.from_dense(R, block_size=B, bandwidth_blocks=hb, s=0.1)
    dense = np.asarray(op.to_dense())
    x = rng.normal(size=(K, M))
    got = np.asarray(op.matvec(jnp.asarray(x)))
    want = np.einsum("kij,kj->ki", dense, x)
    np.testing.assert_allclose(got, want, rtol=1e-10, atol=1e-12)


def test_banded_captures_full_band():
    """With bandwidth_blocks*B >= element band + B, no entries are dropped."""
    rng = np.random.default_rng(2)
    K, M, B = 1, 64, 8
    band = 10   # needs hb = ceil((band + B - 1)/B) = 3 to be safe
    R = _banded_dense(rng, K, M, band)
    op = BandedLD.from_dense(R, block_size=B, bandwidth_blocks=3)
    np.testing.assert_allclose(np.asarray(op.to_dense()), R, atol=1e-14)
    x = rng.normal(size=(K, M))
    np.testing.assert_allclose(np.asarray(op.matvec(jnp.asarray(x))),
                               np.einsum("kij,kj->ki", R, x), rtol=1e-10)
