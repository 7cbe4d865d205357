"""BASELINE north-star fidelity gate: trajectory parity vs the
reference-semantics oracle on a simulated M=100k banded LD panel
(BASELINE.md: "bit-compatible xhat trajectories vs. reference on simulated
M=100k LD panels", to numerical tolerance).

The oracle runs scipy CSR CG exactly like the reference's sparse path;
the engine runs the block-banded operator with padding masks. Variants
cover the full 10-iteration gate (EM), the MLE prior path, and K=2
cohorts — late iterations are where damping/gamw feedback compounds, so
the long gate is the one that catches slow drift.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import scipy.sparse

from sgvamp import PriorState, VampConfig, VampEngine, VampInputs
from sgvamp.core.operators import BandedLD
from sgvamp.data.simulate import simulate_ld_band

from oracle import ReferenceOracle


def _band_to_csr(band):
    M, nd = band.shape
    bw = (nd - 1) // 2
    offs = list(range(-bw, bw + 1))
    return scipy.sparse.diags(
        [band[: M - d, bw + d] if d >= 0 else band[-d:, bw + d] for d in offs],
        offs, shape=(M, M), format="csr", dtype=np.float64,
    )


def _run_pair(K, iters, prior_update, seed=0):
    rng = np.random.default_rng(seed)
    M, N, lam, h2 = 100_000, 300_000, 0.01, 0.7
    cm = int(M * lam)
    bands, rs = [], []
    for _ in range(K):
        band, r, x0 = simulate_ld_band(N, M, bandwidth=32, h2=h2, lam=lam,
                                       rng=rng, dtype=np.float64)
        bands.append(band)
        rs.append(r)
    rs = np.stack(rs)
    u = (rng.integers(0, 2, size=(iters, K, M)) * 2 - 1).astype(np.float64)

    Ns = np.full(K, float(N))
    Nt = float(K * N)
    a = Ns / Nt
    oracle = ReferenceOracle([_band_to_csr(b) for b in bands], rs, a, Ns, Nt,
                             prior_vars=[0.0, h2 / cm], prior_probs=[1 - lam, lam])
    ohist = oracle.run(iters, u, cg_maxit=1000, cg_rtol=1e-12,
                       prior_update=prior_update)

    ops = [BandedLD.from_band(b, block_size=128) for b in bands]
    op = BandedLD(blocks=jnp.concatenate([o.blocks for o in ops], axis=0),
                  s=0.0, accum_dtype=ops[0].accum_dtype)
    Mp = op.M
    mask = np.zeros(Mp)
    mask[:M] = 1.0
    rp = np.zeros((K, Mp))
    rp[:, :M] = rs
    up = np.zeros((iters, K, Mp))
    up[:, :, :M] = u
    cfg = VampConfig(prior_update=prior_update, dtype="float64", cg_maxit=1000,
                     cg_rtol=1e-12)
    prior = PriorState.create(lam, [1.0], [h2 / cm * Nt])
    inputs = VampInputs(op=op, r=jnp.asarray(rp), a=jnp.asarray(a),
                        N=jnp.asarray(Ns), mask=jnp.asarray(mask))
    hist = VampEngine(inputs, cfg, prior).run(iters, fixed_u=up, M_out=M)
    return ohist, hist


@pytest.mark.parametrize("K,iters,prior_update", [
    (1, 10, "em"),    # the full 10-iteration BASELINE gate
    (1, 5, "mle"),
    (2, 5, "em"),
])
def test_trajectory_parity_m100k(K, iters, prior_update):
    ohist, hist = _run_pair(K, iters, prior_update)
    for it in range(iters):
        o, g = ohist["xhat1"][it], hist["xhat1"][it]
        scale = np.linalg.norm(o)
        np.testing.assert_allclose(g, o, atol=1e-6 * scale,
                                   err_msg=f"xhat1 diverged at iteration {it}")
        np.testing.assert_allclose(np.asarray(hist["params"][it]),
                                   np.asarray(ohist["params"][it]), rtol=1e-6)
