"""SymBandedLD tests: the plain-jnp reference and the Pallas (Triton route)
kernel, the latter in interpret mode on CPU. Both are compared with a
float64 dense matrix built from the same stored blocks, and with each
other. The compiled kernel itself runs only on a GPU (the `gpu` marker
below; chip_smoke.py phase 1 checks it at M=524,288).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from sgvamp import PriorState, VampConfig, VampEngine, VampInputs
from sgvamp.core.operators import BandedLD
from sgvamp.data.simulate import band_to_dense, simulate_ld_band
from sgvamp.ops import band_kernel as bk
from sgvamp.ops.band_kernel import SymBandedLD

# (B, bandwidth): block half-bandwidths hb = 0, 1, 4, 1, 2
SHAPES = [(64, 0), (64, 40), (64, 200), (128, 48), (128, 200)]
STORAGE = ["float32", "bfloat16", "int8"]


def _band(M, bw, seed):
    rng = np.random.default_rng(seed)
    if bw == 0:  # diagonal-only panel: no mirrors at all
        return rng.normal(size=(M, 1))
    return simulate_ld_band(10000, M, bandwidth=bw, rng=rng,
                            dtype=np.float64)[0]


def _problem(B, bw, storage, K, S, M=700, seed=0):
    """Operator over K independent panels (M not a block multiple), S*K
    right-hand sides, and the f64 dense matrices of the stored blocks."""
    ops = [SymBandedLD.from_band(_band(M, bw, seed + k), block_size=B,
                                 dtype=storage) for k in range(K)]
    op = SymBandedLD(
        upper=jnp.concatenate([o.upper for o in ops], axis=0),
        scales=(jnp.concatenate([o.scales for o in ops], axis=0)
                if ops[0].scales is not None else None))
    dense = np.asarray(op.to_dense(), np.float64)
    x = np.random.default_rng(seed + 99).normal(size=(S * K, op.M))
    return op, dense, x


def _dense_matvec(dense, x, K):
    """Rows s*K + k of x multiply cohort k's dense matrix."""
    y = np.empty_like(x)
    for j in range(x.shape[0]):
        y[j] = dense[j % K] @ x[j]
    return y


def _close(y, want, tol):
    scale = np.abs(want).max()
    np.testing.assert_allclose(np.asarray(y, np.float64) / scale, want / scale,
                               atol=tol)


def _with(op, impl):
    return dataclasses.replace(op, impl=impl)


@pytest.mark.parametrize("K,S", [(1, 1), (2, 2)])
@pytest.mark.parametrize("B,bw", SHAPES)
@pytest.mark.parametrize("storage", STORAGE)
def test_kernel_matches_dense(storage, B, bw, K, S):
    """Interpret-mode kernel vs f64 dense of the stored blocks: f32
    accumulation over at most 2hb+1 blocks per row."""
    op, dense, x = _problem(B, bw, storage, K, S)
    y = _with(op, "interpret").matvec(jnp.asarray(x))
    _close(y, _dense_matvec(dense, x, K), 1e-5)


@pytest.mark.parametrize("B,bw", SHAPES)
@pytest.mark.parametrize("storage", STORAGE)
def test_reference_matches_dense(storage, B, bw):
    op, dense, x = _problem(B, bw, storage, K=2, S=2, seed=3)
    y = _with(op, "reference").matvec(jnp.asarray(x))
    _close(y, _dense_matvec(dense, x, 2), 1e-5)


@pytest.mark.parametrize("B,bw", SHAPES)
@pytest.mark.parametrize("storage", STORAGE)
def test_kernel_equals_reference(storage, B, bw):
    """Same f32 arithmetic on the same blocks: only summation order differs."""
    op, _, x = _problem(B, bw, storage, K=2, S=2, seed=5)
    xj = jnp.asarray(x, jnp.float32)
    yk = _with(op, "interpret").matvec(xj)
    yr = _with(op, "reference").matvec(xj)
    _close(yk, np.asarray(yr, np.float64), 1e-6)


@pytest.mark.parametrize("impl", ["reference", "interpret"])
@pytest.mark.parametrize("B,bw", [(128, 48), (128, 200), (256, 100)])
def test_matches_dense(B, bw, impl):
    """float64 storage computes in float64: exact to rounding, including the
    regularization and the identity rows of padded markers."""
    rng = np.random.default_rng(0)
    M = 700  # deliberately not a block multiple
    band, _, _ = simulate_ld_band(10000, M, bandwidth=bw, rng=rng,
                                  dtype=np.float64)
    R = band_to_dense(band)
    op = _with(SymBandedLD.from_band(band, block_size=B, s=0.1), impl)
    x = rng.normal(size=(2, op.M))
    y = np.asarray(op.matvec(jnp.asarray(x)))
    want = x[:, :M] @ (0.9 * R + 0.1 * np.eye(M)).T
    np.testing.assert_allclose(y[:, :M], want, rtol=1e-10, atol=1e-12)
    # padded markers carry an identity diagonal: Rused @ x = x there
    np.testing.assert_allclose(y[:, M:], x[:, M:], atol=1e-12)


def test_bf16_storage_f32_accumulate():
    """bf16 upper blocks accumulate in f32 and stay within bf16 rounding of
    the f64 band result."""
    rng = np.random.default_rng(3)
    M = 512
    band, _, _ = simulate_ld_band(10000, M, bandwidth=64, rng=rng,
                                  dtype=np.float64)
    R = band_to_dense(band)
    op = SymBandedLD.from_band(band, block_size=128, dtype="bfloat16")
    assert str(op.upper.dtype) == "bfloat16"
    x = rng.normal(size=(2, op.M))
    for impl in ("reference", "interpret"):
        y = _with(op, impl).matvec(jnp.asarray(x, jnp.float32))
        assert y.dtype == jnp.float32
        _close(y[:, :M], x[:, :M] @ R.T, 2e-2)


@pytest.mark.parametrize("impl", ["reference", "interpret"])
def test_int8_quantized_matvec(impl):
    """int8 per-block storage: half the bytes of bf16, the stored matrix's
    matvec to f32 accuracy, and within the per-block quantization bound
    (|err| <= max|U|/254) of the unquantized matrix."""
    rng = np.random.default_rng(8)
    M, B = 700, 128
    band, _, _ = simulate_ld_band(10000, M, bandwidth=200, rng=rng,
                                  dtype=np.float64)
    R = band_to_dense(band)
    op = _with(SymBandedLD.from_band(band, block_size=B, dtype="int8"), impl)
    assert op.quantized and str(op.upper.dtype) == "int8"
    assert op.scales.shape == (1, op.nb, op.hb + 1)
    assert op.bytes_per_pass() < 0.51 * (op.upper.size * 2 + op.scales.size * 4)
    x = rng.normal(size=(2, op.M))
    y = np.asarray(op.matvec(jnp.asarray(x, jnp.float32)), np.float64)
    Rq = np.asarray(op.to_dense(), np.float64)[0]
    _close(y, x @ Rq.T, 1e-5)
    full = np.zeros((op.M, op.M))
    full[:M, :M] = R
    full[M:, M:] = np.eye(op.M - M)
    _close(y, x @ full.T, 2e-2)


@pytest.mark.parametrize("storage", ["float32", "int8"])
def test_spill_two_shard_composition(storage):
    """The sharded contract, composed by hand: each half-panel's local
    kernel over halo-extended x, plus the previous half's mirror spill
    added into its first hb blocks, reproduces the whole-panel matvec."""
    op, _, x = _problem(64, 100, storage, K=1, S=2, M=1024, seed=7)
    nb, hb, B = op.nb, op.hb, op.B
    nb_l = nb // 2
    xs = jnp.asarray(x, jnp.float32)[None]  # (K=1, S=2, M)
    sc = op.scales if op.quantized else jnp.ones(op.upper.shape[:3])
    ys, spills = [], []
    for sh in range(2):
        ub_l = op.upper[:, sh * nb_l:(sh + 1) * nb_l]
        sc_l = sc[:, sh * nb_l:(sh + 1) * nb_l]
        x_l = xs[:, :, sh * nb_l * B:(sh + 1) * nb_l * B]
        halo = (xs[:, :, nb_l * B:(nb_l + hb) * B] if sh == 0
                else jnp.zeros((1, 2, hb * B)))  # wraparound leg
        x_ext = jnp.concatenate([x_l, halo], axis=2)
        ys.append(bk.sym_band_matvec_pallas(ub_l, sc_l, x_ext, interpret=True))
        spills.append(bk._mirror_spill(ub_l, sc_l if op.quantized else None, x_l))
    y1 = ys[1].at[:, :, :hb * B].add(spills[0])
    got = np.concatenate([np.asarray(ys[0]), np.asarray(y1)], axis=2)[0]
    want = np.asarray(_with(op, "reference").matvec(jnp.asarray(x, jnp.float32)))
    _close(got, want.astype(np.float64), 1e-6)
    # the last shard's spill leaves the global panel: exact zeros
    np.testing.assert_array_equal(np.asarray(spills[1]), 0.0)


@pytest.mark.parametrize("n_shard", [2, 4])
@pytest.mark.parametrize("storage", ["float32", "int8"])
def test_sharded_kernel_matches_unsharded(storage, n_shard):
    """shard_map over virtual CPU devices: halo and spill ppermutes around
    the interpret-mode kernel reproduce the unsharded matvec."""
    from sgvamp.parallel.sharding import make_mesh, shard_inputs

    op, _, x = _problem(64, 100, storage, K=1, S=2, M=1024, seed=11)
    op = _with(op, "interpret")
    xj = jnp.asarray(x, jnp.float32)
    want = np.asarray(op.matvec(xj), np.float64)
    mesh = make_mesh(1, n_shard)
    inputs = VampInputs(op=op, r=xj[:1], a=jnp.asarray([1.0]),
                        N=jnp.asarray([20000.0]))
    sh = shard_inputs(inputs, mesh)
    assert sh.op.mesh is mesh
    if op.quantized:  # scales shard over block rows with the blocks
        assert "shard" in str(sh.op.scales.sharding.spec)
    _close(sh.op.matvec(xj), want, 1e-6)


def test_streamed_matches_dense_K2():
    """K cohorts with different panels: program (i, k) must read cohort k's
    blocks only (row 0 of cohort 1 must not see cohort 0's tail)."""
    op, dense, x = _problem(128, 96, "float32", K=2, S=2, M=512, seed=5)
    y = _with(op, "interpret").matvec(jnp.asarray(x))
    _close(y, _dense_matvec(dense, x, 2), 1e-5)


def test_streamed_diagonal_only_band():
    """hb=0: no mirrors and no halo - the degenerate shape stays exact."""
    rng = np.random.default_rng(6)
    M, B = 384, 128
    band = rng.normal(size=(M, 1))
    op = SymBandedLD.from_band(band, block_size=B)
    assert op.hb == 0
    x = rng.normal(size=(2, M))
    for impl in ("reference", "interpret"):
        y = np.asarray(_with(op, impl).matvec(jnp.asarray(x)))
        np.testing.assert_allclose(y, x * band[:, 0], rtol=1e-12, atol=1e-13)


@pytest.mark.parametrize("backend,impl", [("gpu", "kernel"),
                                          ("cpu", "reference")])
def test_dispatch_by_backend(monkeypatch, backend, impl):
    monkeypatch.setattr(jax, "default_backend", lambda: backend)
    assert bk._impl_for_backend() == impl


@pytest.mark.parametrize("backend", ["METAL", "neuron"])
def test_dispatch_unknown_backend_raises(monkeypatch, backend):
    op, _, x = _problem(64, 40, "float32", K=1, S=1, M=256)
    monkeypatch.setattr(jax, "default_backend", lambda: backend)
    with pytest.raises(ValueError, match="no implementation for backend"):
        op.matvec(jnp.asarray(x))


def test_cpu_default_is_reference_without_interpreter(monkeypatch):
    """On the CPU, an operator with no impl runs the plain reference and
    never reaches the Pallas call (interpret mode only by name)."""
    def refuse(*a, **k):
        raise AssertionError("Pallas kernel called without impl='interpret'")

    monkeypatch.setattr(bk, "sym_band_matvec_pallas", refuse)
    op, dense, x = _problem(64, 40, "int8", K=1, S=2, M=256)
    _close(op.matvec(jnp.asarray(x)), _dense_matvec(dense, x, 1), 1e-5)


def test_unknown_impl_raises():
    op, _, x = _problem(64, 40, "float32", K=1, S=1, M=256)
    with pytest.raises(ValueError, match="unknown SymBandedLD impl"):
        _with(op, "resident").matvec(jnp.asarray(x))


def test_kernel_needs_power_of_two_block():
    op, _, x = _problem(96, 40, "float32", K=1, S=1, M=384)
    with pytest.raises(ValueError, match="power-of-two block size"):
        _with(op, "interpret").matvec(jnp.asarray(x))


def test_int8_words_full_range_equals_reference():
    """Raw int8 blocks over the whole range [-127, 127] with arbitrary
    scales: the word kernel's byte unpacking (sign included) and its
    interleaved row order agree with the reference."""
    rng = np.random.default_rng(14)
    K, nb, hb, B, S = 2, 5, 2, 64, 2
    upper = jnp.asarray(rng.integers(-127, 128, (K, nb, hb + 1, B, B)), jnp.int8)
    scales = jnp.asarray(rng.uniform(0.1, 2.0, (K, nb, hb + 1)), jnp.float32)
    x = jnp.asarray(rng.normal(size=(K, S, nb * B)), jnp.float32)
    yk = bk.sym_band_matvec_pallas(upper, scales, x, interpret=True)
    yr = bk.sym_band_matvec_ref(upper, scales, x)
    _close(yk, np.asarray(yr, np.float64), 1e-6)


@pytest.mark.parametrize("K,nb", [(1, 4096), (8, 8192)])
def test_kernel_operands_fit_32_bit_offsets(monkeypatch, K, nb):
    """The Triton lowering indexes an operand of at most 2**32 bytes with
    signed 32-bit element offsets. int8 blocks reach the kernel as int32
    words, so every operand stays indexable, including the 3.2 GB of
    blocks of K=8 cohorts at M=1,048,576 (abstract shapes, no memory)."""
    seen = []
    real = bk.pl.pallas_call

    def spy(kernel, **kw):
        call = real(kernel, **kw)

        def run(*args):
            seen.extend(args)
            return call(*args)
        return run

    monkeypatch.setattr(bk.pl, "pallas_call", spy)
    B, hb, S = 128, 2, 2
    jax.eval_shape(bk.sym_band_matvec_pallas,
                   jax.ShapeDtypeStruct((K, nb, hb + 1, B, B), jnp.int8),
                   jax.ShapeDtypeStruct((K, nb, hb + 1), jnp.float32),
                   jax.ShapeDtypeStruct((K, S, nb * B), jnp.float32))
    assert seen[0].dtype == jnp.int32 and seen[0].shape[-1] == B // 4
    for a in seen:
        assert a.size * a.dtype.itemsize > 2**32 or a.size <= 2**31


def test_int8_engine_close_to_f32():
    """Full VAMP trajectory with int8 LD storage stays close to the f32
    trajectory (the fixed point is robust to operator quantization)."""
    rng = np.random.default_rng(9)
    N, M, lam, h2, iters = 20000, 400, 0.1, 0.7, 4
    band, r, x0 = simulate_ld_band(N, M, bandwidth=32, rng=rng,
                                   dtype=np.float64, h2=h2, lam=lam)
    u = (rng.integers(0, 2, size=(iters, 1, 512)) * 2 - 1).astype(np.float64)
    cfg = VampConfig(prior_update="em", dtype="float32", cg_maxit=200,
                     cg_rtol=1e-7)
    prior = PriorState.create(lam, [1.0], [h2 / int(M * lam) * N])
    hists = {}
    for name, op in [
            ("f32", SymBandedLD.from_band(band, block_size=128,
                                          dtype="float32")),
            ("int8", SymBandedLD.from_band(band, block_size=128,
                                           dtype="int8"))]:
        Mp = op.M
        mask = np.zeros(Mp)
        mask[:M] = 1.0
        rp = np.zeros(Mp)
        rp[:M] = r
        inputs = VampInputs(op=op, r=jnp.asarray(rp, jnp.float32)[None],
                            a=jnp.asarray([1.0], jnp.float32),
                            N=jnp.asarray([float(N)], jnp.float32),
                            mask=jnp.asarray(mask, jnp.float32))
        hists[name] = VampEngine(inputs, cfg, prior).run(
            iters, fixed_u=u[:, :, :Mp], M_out=M)
    for it in range(iters):
        a, b = hists["int8"]["xhat1"][it], hists["f32"]["xhat1"][it]
        denom = np.linalg.norm(b) + 1e-30
        assert np.linalg.norm(a - b) / denom < 0.05, f"iteration {it}"
    ca = np.corrcoef(hists["int8"]["xhat1"][-1], hists["f32"]["xhat1"][-1])[0, 1]
    assert ca > 0.999


def test_int8_sharded_matches_unsharded():
    """int8 storage through the shard_map path: the scales leaf must shard
    with the blocks (not replicate via the index-table heuristic)."""
    from sgvamp.parallel.sharding import make_mesh, shard_inputs

    rng = np.random.default_rng(10)
    M, B, bw = 512, 64, 100
    band, r, _ = simulate_ld_band(20000, M, bandwidth=bw, rng=rng,
                                  dtype=np.float64)
    op = SymBandedLD.from_band(band, block_size=B, dtype="int8")
    x = rng.normal(size=(2, op.M)).astype(np.float32)
    want = np.asarray(op.matvec(jnp.asarray(x)))
    mesh = make_mesh(1, 4)
    inputs = VampInputs(op=op, r=jnp.asarray(r, jnp.float32)[None],
                        a=jnp.asarray([1.0]), N=jnp.asarray([20000.0]))
    sh = shard_inputs(inputs, mesh)
    assert sh.op.mesh is mesh
    assert "shard" in str(sh.op.scales.sharding.spec)
    got = np.asarray(sh.op.matvec(jnp.asarray(x)))
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)


def test_matches_banded_operator_in_engine():
    """Full engine equivalence: SymBandedLD vs BandedLD trajectories."""
    rng = np.random.default_rng(1)
    N, M, lam, h2, iters = 20000, 400, 0.1, 0.7, 3
    band, r, x0 = simulate_ld_band(N, M, bandwidth=32, rng=rng,
                                   dtype=np.float64, h2=h2, lam=lam)
    u = (rng.integers(0, 2, size=(iters, 1, 512)) * 2 - 1).astype(np.float64)
    cfg = VampConfig(prior_update="em", dtype="float64", cg_maxit=300,
                     cg_rtol=1e-12)
    prior = PriorState.create(lam, [1.0], [h2 / int(M * lam) * N])
    hists = {}
    for name, op in [("einsum", BandedLD.from_band(band, block_size=128)),
                     ("sym", SymBandedLD.from_band(band, block_size=128))]:
        Mp = op.M
        mask = np.zeros(Mp)
        mask[:M] = 1.0
        rp = np.zeros(Mp)
        rp[:M] = r
        inputs = VampInputs(op=op, r=jnp.asarray(rp)[None], a=jnp.asarray([1.0]),
                            N=jnp.asarray([float(N)]), mask=jnp.asarray(mask))
        hists[name] = VampEngine(inputs, cfg, prior).run(
            iters, fixed_u=u[:, :, :Mp], M_out=M)
    for it in range(iters):
        np.testing.assert_allclose(hists["sym"]["xhat1"][it],
                                   hists["einsum"]["xhat1"][it],
                                   rtol=1e-9, atol=1e-11)


@pytest.mark.gpu
def test_compiled_kernel_matches_reference(gpu):
    """The Triton-compiled kernel on the card (no interpreter) vs the plain
    reference, int8 storage."""
    op, _, x = _problem(128, 200, "int8", K=2, S=2, M=4096, seed=13)
    xj = jnp.asarray(x, jnp.float32)
    yk = _with(op, "kernel").matvec(xj)
    yr = _with(op, "reference").matvec(xj)
    _close(yk, np.asarray(yr, np.float64), 1e-6)
