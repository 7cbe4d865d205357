"""CheckpointManager tests: round trip, GC, resume continuation, and
run_scan/host-loop equivalence on the banded+mask path."""

import os

import jax.numpy as jnp
import numpy as np

from sgvamp import PriorState, VampConfig, VampEngine, VampInputs
from sgvamp.core.operators import BandedLD
from sgvamp.data.simulate import simulate_ld_band
from sgvamp.io.checkpoint import CheckpointManager


def _engine(M=200, N=20000, cfg=None):
    rng = np.random.default_rng(0)
    lam, h2 = 0.1, 0.7
    band, r, x0 = simulate_ld_band(N, M, bandwidth=24, rng=rng,
                                   dtype=np.float64, h2=h2, lam=lam)
    op = BandedLD.from_band(band, block_size=64)
    Mp = op.M
    mask = np.zeros(Mp)
    mask[:M] = 1.0
    rp = np.zeros(Mp)
    rp[:M] = r
    cfg = cfg or VampConfig(prior_update="em", dtype="float64", cg_maxit=200)
    prior = PriorState.create(lam, [1.0], [h2 / int(M * lam) * N])
    inputs = VampInputs(op=op, r=jnp.asarray(rp)[None], a=jnp.asarray([1.0]),
                        N=jnp.asarray([float(N)]), mask=jnp.asarray(mask))
    return VampEngine(inputs, cfg, prior)


def test_checkpoint_roundtrip_and_gc(tmp_path):
    eng = _engine()
    ck = CheckpointManager(str(tmp_path), keep=2)
    state = eng.init_state(seed=9)
    for it in range(1, 5):
        hist = eng.run(1, state=state)
        state = hist["state"]
        ck.save(state, it)
    files = sorted(os.listdir(tmp_path))
    assert files == ["vamp_state_000003.npz", "vamp_state_000004.npz"]

    restored, it = ck.restore_latest(eng.init_state(seed=9))
    assert it == 4
    np.testing.assert_allclose(np.asarray(restored.xhat1),
                               np.asarray(state.xhat1))
    np.testing.assert_allclose(np.asarray(restored.r1), np.asarray(state.r1))
    assert int(restored.it) == int(state.it)


def test_restore_none_when_empty(tmp_path):
    eng = _engine()
    ck = CheckpointManager(str(tmp_path))
    assert ck.restore_latest(eng.init_state()) is None


def test_resumed_run_continues_exact_trajectory(tmp_path):
    eng = _engine()
    full = eng.run(6, seed=3)

    ck = CheckpointManager(str(tmp_path))
    h1 = eng.run(3, seed=3, callback=lambda it, st, aux: ck.save(st, it + 1))
    restored, it0 = ck.restore_latest(eng.init_state(seed=3))
    assert it0 == 3
    h2 = eng.run(3, state=restored, it0=it0)
    np.testing.assert_allclose(h2["xhat1"][-1], full["xhat1"][-1], rtol=1e-12)


def test_run_scan_matches_host_loop_banded_mask():
    eng = _engine()
    hist = eng.run(4, seed=21)
    final, aux = eng.run_scan(4, seed=21)
    np.testing.assert_allclose(np.asarray(final.xhat1), hist["xhat1"][-1],
                               rtol=1e-12)
