"""sgvamp benchmark: VAMP iterations/sec on a biobank-scale banded LD panel.

Measures the full jit-compiled VAMP iteration (denoiser + EM prior + two
CG solves + Hutchinson + gamw learning) on one GPU at M=512k markers,
bandwidth 256, with a fixed CG budget (cg_force_maxiter: exactly cg_maxit
fused LD passes per solve) so per-iteration work is deterministic. The
headline iter/s is the median over several multi-step timed blocks.

The per-pass matvec time comes from n-vs-2n chained fori_loop differencing
(fixed dispatch costs cancel). The same child measures a plain-jnp read of
the same block array (a reduction over every byte) as the bandwidth
reached by XLA in that call, and both are reported against the card's
published peak (HBM_PEAK_GBPS, keyed by device_kind; an unknown device
is an error).

Default configuration: the symmetric operator with int8 per-block
quantized storage, B=128 (SGVAMP_BENCH_OPERATOR / SGVAMP_BENCH_LD_DTYPE /
SGVAMP_BENCH_B / SGVAMP_BENCH_K override). A production-mode solve
(solve_rtol1e5) records time-to-tolerance of plain vs block-Jacobi
preconditioned CG on an ill-conditioned panel (SGVAMP_BENCH_SOLVE=0 skips
it).

Baseline: the reference implementation's per-iteration cost on this host's
CPU, assembled from its measured parts (scipy CSR CG matvecs at the same
fixed budget, the per-marker Python denoiser loops sampled and scaled to
M, and one vectorized EM sweep).

Device work runs only in child processes, one at a time (each JAX process
reserves most of the card's memory); a child that finds no GPU exits
non-zero unless SGVAMP_BENCH_PLATFORM=cpu asks for the CPU. Prints ONE
JSON line:
  {"metric": "vamp_iters_per_sec_M512k", "value": ..., "unit": "iter/s",
   "vs_baseline": <speedup over reference CPU implementation>, ...extras}
"""

import json
import os
import sys
import time

import numpy as np

# Published device-memory bandwidth, GB/s, by jax device_kind (NVIDIA H100
# SXM5 data sheet). A device missing here is an error, not a default.
HBM_PEAK_GBPS = {"NVIDIA H100 80GB HBM3": 3350.0}

N_SAMPLES, LAM, H2 = 300000, 0.01, 0.7
_DEFAULT_LD_DTYPE = "int8"


def hbm_peak_gbps(device_kind: str) -> float:
    if device_kind not in HBM_PEAK_GBPS:
        raise KeyError(f"no published memory bandwidth for device {device_kind!r}; "
                       f"add it to HBM_PEAK_GBPS with its source")
    return HBM_PEAK_GBPS[device_kind]


def _stage(msg):
    print(f"[bench] {time.strftime('%H:%M:%S')} {msg}", file=sys.stderr, flush=True)


def build_problem(M, bandwidth, N, lam, h2, seed=0, K=1):
    """K > 1 returns r of shape (K, M): K independent cohorts (shared panel
    + signal, independent noise draws) - a genuine meta-analysis. Identical
    replication instead makes the meta denoiser overconfident by K and the
    EM prior collapses (measured: lam 0.01 -> 0.91 in 3 iterations)."""
    from sgvamp.data.simulate import simulate_ld_band

    ktag = f"_K{K}" if K > 1 else ""
    cache = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                         f".bench_problem_M{M}_bw{bandwidth}{ktag}_s{seed}.npz")
    if os.path.exists(cache):
        with np.load(cache) as d:
            return d["band"], d["r"], d["x0"]
    rng = np.random.default_rng(seed)
    band, r, x0 = simulate_ld_band(N, M, bandwidth, h2=h2, lam=lam, rng=rng,
                                   dtype=np.float32, n_r=K)
    try:
        np.savez(cache, band=band, r=r, x0=x0)
    except OSError:
        pass
    return band, r, x0


def _setup(band, r, N, lam, h2, cg_maxit, block_size):
    import jax
    import jax.numpy as jnp

    from sgvamp import PriorState, VampConfig, VampInputs
    from sgvamp.core import vamp as V
    from sgvamp.core.operators import BandedLD
    from sgvamp.ops.band_kernel import SymBandedLD

    M = r.shape[-1]  # r is (M,) or (K, M) independent cohorts
    cm = max(int(M * lam), 1)
    K = int(os.environ.get("SGVAMP_BENCH_K", "1"))
    _stage("packing blocks + device transfer")
    ld_dtype = os.environ.get("SGVAMP_BENCH_LD_DTYPE", _DEFAULT_LD_DTYPE)
    if os.environ.get("SGVAMP_BENCH_OPERATOR", "sym") == "sym":
        op = SymBandedLD.from_band(band, block_size=block_size, dtype=ld_dtype,
                                   K=K)
    else:
        op = BandedLD.from_band(band, block_size=block_size, dtype=ld_dtype,
                                K=K)
    jax.block_until_ready(op)
    Mp = op.M
    dt = jnp.float32
    mask = np.zeros(Mp, np.float32)
    mask[:M] = 1.0
    rp = np.zeros((K, Mp), np.float32)
    rp[:, :M] = r
    # cg_force_maxiter makes per-iteration work exactly deterministic:
    # cg_maxit fused passes for the two solves + 1 residual + 1 gamw pass.
    cfg = VampConfig(prior_update="em", dtype="float32", cg_maxit=cg_maxit,
                     cg_force_maxiter=True, em_prior_maxit=5, rho=0.5,
                     lmmse_damp=True)
    # K>1 cohorts share the panel and the true signal (independent noise
    # draws, build_problem K=...), so the matched slab variance is the
    # single-cohort signal scale h2/cm*N regardless of K.
    prior = PriorState.create(lam, [1.0], [h2 / cm * N])
    inputs = VampInputs(op=op, r=jnp.asarray(rp),
                        a=jnp.full((K,), 1.0 / K, dt),
                        N=jnp.full((K,), float(N), dt),
                        mask=jnp.asarray(mask))
    state = V.init_state(inputs, cfg, prior, gamw=5.0, gam1=1e-6)
    return op, inputs, state, cfg


def per_pass_seconds(fn, args, x, n=32, reps=3):
    """Seconds per application of fn(args, x) -> same-shape x, from chained
    lax.fori_loop runs of n and 2n passes inside one jit: the difference
    cancels dispatch and launch costs. n is traced, so both lengths share
    one compiled program; args (operators, blocks) are passed as jit
    arguments, never captured as constants."""
    import jax

    chain = jax.jit(lambda a, v, n: jax.lax.fori_loop(
        0, n, lambda _, v: fn(a, v), v))

    def timed(n):
        jax.block_until_ready(chain(args, x, n))  # compile + warm
        best = float("inf")
        for _ in range(reps):
            t0 = time.perf_counter()
            jax.block_until_ready(chain(args, x, n))
            best = min(best, time.perf_counter() - t0)
        return best

    return max((timed(2 * n) - timed(n)) / n, 1e-12)


def read_probe_seconds(arr, n=32, reps=3):
    """Seconds for XLA to read every byte of `arr` once: a max-reduction
    whose carry feeds the next pass, so no pass can be hoisted."""
    import jax.numpy as jnp

    def one(a, c):
        return jnp.max(a.astype(jnp.float32) + c[0]).reshape(1) * 1e-3

    return per_pass_seconds(one, arr, jnp.zeros((1,), jnp.float32), n, reps)


def time_matvec_child(band, r, N, lam, h2, cg_maxit, block_size):
    """Per-pass matvec time and the same-call read probe over the blocks."""
    import jax

    op, inputs, state, cfg = _setup(band, r, N, lam, h2, cg_maxit, block_size)
    blocks = jax.tree_util.tree_leaves(op)[0]
    _stage("timing matvec (chained, differenced)")
    x = inputs.r.repeat(2, axis=0)
    # 0.02 damping keeps the iterate finite over n unnormalized passes
    matvec_s = per_pass_seconds(lambda o, v: o.matvec(v) * 0.02, op, x)
    _stage("timing plain read of the same blocks")
    read_s = read_probe_seconds(blocks)
    return matvec_s, read_s, int(op.bytes_per_pass()), int(blocks.nbytes)


def time_step_child(band, r, N, lam, h2, iters, cg_maxit, block_size, x0=None,
                    repeats=4):
    """Full-step timing. The warmup step compiles the program and advances
    to it=1; each of `repeats` timed blocks of `iters` chained steps
    restarts from that snapshot, so every block does identical work."""
    import jax

    from sgvamp.core import vamp as V

    op, inputs, state, cfg = _setup(band, r, N, lam, h2, cg_maxit, block_size)
    step = jax.jit(lambda s, i: V.vamp_step(s, i, cfg, None))

    _stage("compiling step")
    t0 = time.time()
    state, aux = step(state, inputs)
    jax.block_until_ready(state)
    compile_s = time.time() - t0
    state1 = state

    def _align(xh):
        xh = np.asarray(xh[: x0.shape[0]], np.float64)
        denom = np.linalg.norm(xh) * np.linalg.norm(x0)
        a = float(xh @ np.asarray(x0, np.float64) / denom) if denom else 0.0
        return a if np.isfinite(a) else -1.0

    # Quality gate at the reference's default iteration budget
    # (iterations=10): alignment at it=10, the best over the trajectory
    # (the reference's post-hoc CSV selection), and the iterate the
    # engine's truth-free StopMonitor selects (what --stop-on-divergence
    # delivers).
    align, align_best, align_best_it = -1.0, -1.0, -1
    align_stop, stop_it, stop_reason = -1.0, -1, None
    if x0 is not None:
        _stage("quality gate: 10 reference-default iterations + StopMonitor")
        mon = V.StopMonitor(tol=1e-4, gam1_drop=10.0)
        mon.update(1, np.asarray(state.xhat1), np.asarray(aux.gam1))
        align_best, align_best_it = _align(state.xhat1), 1
        for gate_it in range(2, 11):
            state, aux = step(state, inputs)
            a = _align(state.xhat1)
            if a > align_best:
                align_best, align_best_it = a, gate_it
            mon.update(gate_it, np.asarray(state.xhat1), np.asarray(aux.gam1))
        align = _align(state.xhat1)
        stop_it, stop_reason = mon.stopped_at, mon.reason
        if mon.best_xhat1 is not None:
            align_stop = _align(mon.best_xhat1)

    _stage(f"timing {repeats} blocks x {iters} steps (each from the it=1 snapshot)")
    samples = []
    for _ in range(repeats):
        state = state1
        t0 = time.time()
        for _ in range(iters):
            state, aux = step(state, inputs)
        jax.block_until_ready(state)
        samples.append((time.time() - t0) / iters)
    finite = bool(jax.numpy.all(jax.numpy.isfinite(state.xhat2)))
    return {"iter_s_samples": samples, "compile_s": compile_s,
            "finite": finite, "align": align, "align_best": align_best,
            "align_best_it": align_best_it, "align_stop": align_stop,
            "stop_it": stop_it, "stop_reason": stop_reason}


def time_solve_child(block_size):
    """Production-mode (rtol=1e-5) CG time-to-tolerance, plain vs
    block-Jacobi preconditioned, on an ill-conditioned LD panel
    (simulate_ld_band strength=4: near-singular local correlation, the
    regime the reference's cg_maxit=500 default anticipates)."""
    import jax
    import jax.numpy as jnp

    from sgvamp.core.cg import cg_batched
    from sgvamp.core.precond import apply_block_jacobi, block_jacobi_inverse
    from sgvamp.data.simulate import simulate_ld_band
    from sgvamp.ops.band_kernel import SymBandedLD

    M, bandwidth, _, _, _ = _params()
    ld_dtype = os.environ.get("SGVAMP_BENCH_LD_DTYPE", _DEFAULT_LD_DTYPE)
    _stage("building hard problem")
    rng = np.random.default_rng(0)
    band, r, _ = simulate_ld_band(N_SAMPLES, M, bandwidth, h2=H2, lam=LAM,
                                  rng=rng, dtype=np.float32,
                                  strength=4.0, decay=0.97)
    op = SymBandedLD.from_band(band, block_size=block_size, dtype=ld_dtype)
    jax.block_until_ready(op.upper)
    gamw = jnp.asarray([40.0])
    gam2 = jnp.asarray([1.0])
    rng = np.random.default_rng(1)
    u = (rng.integers(0, 2, size=(1, op.M)) * 2.0 - 1.0).astype(np.float32)
    b = jnp.concatenate([jnp.asarray(r, jnp.float32).reshape(1, -1),
                         jnp.asarray(u)], axis=0)
    gamw2 = jnp.concatenate([gamw, gamw])
    gam22 = jnp.concatenate([gam2, gam2])
    maxit = 400
    pblock = int(os.environ.get("SGVAMP_BENCH_PRECOND_BLOCK", "64"))
    pdtype = os.environ.get("SGVAMP_BENCH_PRECOND_DTYPE", "bfloat16")

    def mv(o, v):
        return gamw2[:, None] * o.matvec(v) + gam22[:, None] * v

    @jax.jit
    def solve_plain(o, bb):
        res = cg_batched(lambda v: mv(o, v), bb, jnp.zeros_like(bb),
                         maxiter=maxit, rtol=1e-5)
        return res.x, res.iters, res.converged

    @jax.jit
    def solve_pre(o, bb):
        pinv = block_jacobi_inverse(o, gamw, gam2, pblock,
                                    dtype=jnp.dtype(pdtype))
        res = cg_batched(lambda v: mv(o, v), bb, jnp.zeros_like(bb),
                         maxiter=maxit, rtol=1e-5,
                         precond=lambda v: apply_block_jacobi(pinv, v))
        return res.x, res.iters, res.converged

    out = {"precond_block": pblock, "precond_dtype": pdtype,
           "ld_dtype": ld_dtype}
    _stage("timing plain vs preconditioned solve")
    # a fresh right-hand side, made outside the timed region: its eager
    # multiply compiles on first use
    b_timed = jax.block_until_ready(b * (1.0 + 1e-6))
    for name, fn in (("plain", solve_plain), ("precond", solve_pre)):
        jax.block_until_ready(fn(op, b))  # compile + warm
        t0 = time.time()
        xs, iters, conv = jax.block_until_ready(fn(op, b_timed))
        out[f"{name}_s"] = time.time() - t0
        out[f"{name}_iters"] = int(np.max(np.asarray(iters)))
        out[f"{name}_converged"] = bool(np.all(np.asarray(conv)))
    out["speedup"] = out["plain_s"] / max(out["precond_s"], 1e-9)
    return out


def run_child(mode, budget_s):
    """Run one timing child in a subprocess under a time budget; returns
    its JSON dict, or None when it failed or ran out of time."""
    import subprocess

    env = dict(os.environ)
    env["SGVAMP_BENCH_CHILD"] = mode
    try:
        out = subprocess.run(
            [sys.executable, os.path.abspath(__file__)],
            env=env, capture_output=True, timeout=max(60, budget_s), text=True,
        )
    except subprocess.TimeoutExpired:
        _stage(f"{mode} child exceeded its budget")
        return None
    for line in out.stdout.splitlines():
        if line.startswith("{"):
            return json.loads(line)
    _stage(f"{mode} child failed: {out.stderr[-500:]}")
    return None


def baseline_cpu(band, r, N, lam, h2, cg_maxit, sample_markers=2000,
                 measure_M=65536):
    """Reference-equivalent per-iteration cost on CPU (component-wise).

    The scipy CSR matvec is measured on a measure_M-marker slice of the
    same band and scaled linearly to M (CSR matvec cost is linear in nnz
    and memory-bound); the per-marker Python denoiser loops are sampled
    over sample_markers and scaled to M. Both scalings favor the baseline
    (no cache-pressure penalty at full size).
    """
    import scipy.sparse

    M = r.shape[0]
    bw = (band.shape[1] - 1) // 2
    Mb = min(M, measure_M)
    bandb = band[:Mb]
    # CSR assembly from band storage (the reference's storage format,
    # src/main.py:257).
    offs = list(range(-bw, bw + 1))
    R = scipy.sparse.diags(
        [bandb[:Mb - d, bw + d] if d >= 0 else bandb[-d:, bw + d]
         for d in offs],
        offs, shape=(Mb, Mb), format="csr", dtype=np.float64)
    x = np.asarray(r[:Mb], np.float64)

    # (a) CG matvec cost at the same fixed budget: 2 solves x cg_maxit
    # matvecs + 2 extra matvecs for gamw learning (sgvamp.py:352,359).
    reps = 5
    t0 = time.time()
    y = x
    for _ in range(reps):
        y = R @ y
    matvec_s = (time.time() - t0) / reps * (M / Mb)
    n_matvecs = 2 * cg_maxit + 2

    # (b) per-marker Python denoiser + derivative loops (sgvamp.py:273,285),
    # sampled and scaled to M.
    sigmas = np.asarray([h2 / max(int(M * lam), 1) * N])
    omegas = np.asarray([1.0])
    a = np.asarray([1.0])
    gam1s = np.asarray([1.0])

    def denoiser_meta(rs, gam1s):
        s2 = 1.0 / (np.sum(a * gam1s) + 1.0 / sigmas)
        mu = np.inner(rs, a * gam1s) * s2
        mi = int(np.argmax(mu * mu / s2))
        E = np.exp(0.5 * (mu * mu * s2[mi] - mu[mi] ** 2 * s2) / (s2 * s2[mi]))
        num = lam * np.sum(omegas * E * mu * np.sqrt(s2 / sigmas))
        E2 = np.exp(-0.5 * mu[mi] ** 2 / s2[mi])
        den = (1 - lam) * E2 + lam * np.sum(omegas * E * np.sqrt(s2 / sigmas))
        return num / den

    sub = x[:sample_markers]
    t0 = time.time()
    _ = [denoiser_meta(np.asarray([v]), gam1s) for v in sub]
    denoise_sample_s = time.time() - t0
    # xhat1 loop + derivative loop are the same cost shape (two M-loops).
    denoise_s = 2.0 * denoise_sample_s * (M / sample_markers)

    # (c) one vectorized EM sweep x em_prior_maxit(=5, as configured above)
    r1s = x.reshape(1, Mb)
    t0 = time.time()
    for _ in range(5):
        v = sigmas.reshape(1, 1, 1) + 1.0
        E = -(r1s ** 2)[:, :, None] / (2 * v)
        m = E.max(axis=2, keepdims=True)
        xi = lam * np.exp(E - m) / np.sqrt(v)
        sxi = xi.sum(axis=2, keepdims=True)
        pi = 1.0 / (1.0 + (1 - lam) * np.exp(-(r1s ** 2)[:, :, None] / 2 - m) / sxi)
    em_s = (time.time() - t0) * (M / Mb)

    per_iter = n_matvecs * matvec_s + denoise_s + em_s
    return per_iter, {"matvec_s": matvec_s, "denoise_s": denoise_s, "em_s": em_s}


def _params():
    """(M, bandwidth, block_size, cg_maxit, timed iterations per block)."""
    size = os.environ.get("SGVAMP_BENCH_SIZE", "large")
    B = int(os.environ.get("SGVAMP_BENCH_B", "128"))
    if size == "small":  # quick smoke (tests, CPU)
        return 16384, 128, B, 20, 3
    if size == "xl":  # combine with SGVAMP_BENCH_K=8
        return 1048576, 256, B, 100, 3
    return 524288, 256, B, 100, 3


def _device_or_exit():
    """Select the child's platform: the CPU only when SGVAMP_BENCH_PLATFORM
    asks for it, otherwise a GPU or a non-zero exit."""
    import jax

    plat = os.environ.get("SGVAMP_BENCH_PLATFORM")
    if plat:
        jax.config.update("jax_platforms", plat)
    dev = jax.devices()[0]
    if dev.platform != (plat or "gpu"):
        _stage(f"no {plat or 'gpu'} device (found {dev.platform}); refusing to measure")
        sys.exit(3)
    return dev


def child_main(mode):
    """Subprocess entry: run one timing mode, print one JSON line."""
    from sgvamp.utils.compile_cache import enable_compile_cache

    dev = _device_or_exit()
    enable_compile_cache()
    M, bandwidth, block_size, cg_maxit, iters = _params()
    device = {"platform": dev.platform, "kind": dev.device_kind}
    if mode == "solve":
        print(json.dumps({**time_solve_child(block_size), "device": device}))
        return
    band, r, x0 = build_problem(M, bandwidth, N_SAMPLES, LAM, H2,
                                K=int(os.environ.get("SGVAMP_BENCH_K", "1")))
    if mode == "step":
        result = time_step_child(
            band, r, N_SAMPLES, LAM, H2, iters, cg_maxit, block_size, x0=x0)
    else:
        matvec_s, read_s, bpp, nbytes = time_matvec_child(
            band, r, N_SAMPLES, LAM, H2, cg_maxit, block_size)
        result = {"matvec_s": matvec_s, "read_s": read_s,
                  "bytes_per_pass": bpp, "read_bytes": nbytes}
    print(json.dumps({**result, "device": device}))


def main():
    M, bandwidth, block_size, cg_maxit, iters = _params()
    N, lam, h2 = N_SAMPLES, LAM, H2
    budget = float(os.environ.get("SGVAMP_BENCH_BUDGET_S", "1500"))
    K = int(os.environ.get("SGVAMP_BENCH_K", "1"))

    _stage("building problem")
    t0 = time.time()
    band, r, x0 = build_problem(M, bandwidth, N, lam, h2, K=K)
    gen_s = time.time() - t0
    if r.ndim == 2:  # CPU baseline runs the first cohort's system
        r = r[0]

    got = run_child("step", budget / 2)
    mv = run_child("matvec", budget / 4)
    solve = (run_child("solve", budget / 4)
             if os.environ.get("SGVAMP_BENCH_SOLVE", "1") == "1" else None)
    if got is None or mv is None:
        _stage("a timing child failed; no result")
        sys.exit(1)

    _stage("measuring CPU baseline")
    base_s, base_parts = baseline_cpu(band, r, N, lam, h2, cg_maxit)
    _stage("done")

    samples = got["iter_s_samples"]
    iter_s = float(np.median(samples))
    passes = cg_maxit + 2  # fused solves + 1 residual + 1 gamw pass
    bytes_per_pass = mv["bytes_per_pass"]
    matvec_gbps = bytes_per_pass / mv["matvec_s"] / 1e9
    read_gbps = mv["read_bytes"] / mv["read_s"] / 1e9
    peak = hbm_peak_gbps(mv["device"]["kind"])
    result = {
        "metric": f"vamp_iters_per_sec_M{M // 1024}k",
        "value": 1.0 / iter_s,
        "unit": "iter/s",
        "vs_baseline": base_s / iter_s,
        "device": mv["device"],
        "iter_ms_median": iter_s * 1e3,
        "iter_ms_min": float(np.min(samples)) * 1e3,
        "iter_ms_samples": [s * 1e3 for s in samples],
        "ld_passes_per_iter": passes,
        "bytes_per_pass": int(bytes_per_pass),
        "matvec_ms": mv["matvec_s"] * 1e3,
        "matvec_GBps": matvec_gbps,
        "read_probe_GBps": read_gbps,
        "hbm_peak_GBps": peak,
        "matvec_frac_of_peak": matvec_gbps / peak,
        "matvec_frac_of_read_probe": matvec_gbps / read_gbps,
        "compile_s": got["compile_s"],
        "gen_s": gen_s,
        "state_finite": got["finite"],
        "align_vs_x0": got["align"],
        "align_best_vs_x0": got["align_best"],
        "align_best_it": got["align_best_it"],
        "align_stop_vs_x0": got["align_stop"],
        "stop_it": got["stop_it"],
        "stop_reason": got["stop_reason"],
        "solve_rtol1e5": solve,
        "baseline_iter_s": base_s,
        "baseline_parts": base_parts,
        "M": M, "bandwidth": bandwidth, "cg_maxit": cg_maxit,
        "block_size": block_size,
        "operator": os.environ.get("SGVAMP_BENCH_OPERATOR", "sym"),
        "ld_dtype": os.environ.get("SGVAMP_BENCH_LD_DTYPE", _DEFAULT_LD_DTYPE),
        "K": K,
    }
    print(json.dumps(result))


if __name__ == "__main__":
    mode = os.environ.get("SGVAMP_BENCH_CHILD")
    if mode:
        child_main(mode)
    else:
        main()
