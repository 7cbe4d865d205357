"""GPU smoke run of the gVAMP main path at real width.

    python chip_smoke.py               # one GPU: phases 1-4 below
    python chip_smoke.py --four-cards  # four GPUs: the mesh phase only

Phases, all in this one process (each JAX process reserves most of a
card's memory):

  1. kernel parity: the compiled symmetric LD kernel against the plain-jnp
     reference and a float64 host band matvec, M=524,288, bandwidth 256,
     B=128, f32 and int8 storage, S=2 right-hand sides, K=2 cohorts; then
     int8 at K=8 cohorts over M=1,048,576 markers, past 2 GiB of blocks;
  2. the production CLI run (README) through sgvamp.cli.main: operator
     sym, int8 LD, preconditioned CG to rtol 1e-5, divergence stop;
     checks the reference-format outputs and the stop-selected alignment;
  3. the same problem through --operator banded (f32, plain XLA) for 2
     iterations: its xhat must match the sym int8 run's;
  4. a fixed-budget VAMP step (cg_maxit=100 forced: 102 LD passes) and
     per-pass matvec times: kernel vs plain reference, BandedLD bf16/f32,
     K=1 and K=8 over a shared panel.

--four-cards runs K=4 cohorts over the shared int8 panel on a
(cohort=4, shard=1) and a (cohort=1, shard=4) mesh, 3 iterations each,
against the same run on one card.

Exits non-zero without a result when JAX finds no GPU. The last line is
{"ok": true, "device": {"platform": ..., "kind": ..., "count": ...}}.
"""

import argparse
import dataclasses
import glob
import json
import os
import shutil
import subprocess
import sys
import time

import numpy as np

REPO = os.path.dirname(os.path.abspath(__file__))
DATA = os.path.join(REPO, ".biobank")  # gitignored
M, BW, B = 524288, 256, 128
N_SAMPLES, LAM, H2 = 300000, 0.01, 0.7

# Stated bounds (relative L2 unless noted).
KERNEL_VS_REF = 1e-5      # both f32 on the same blocks; summation order only
F32_VS_F64 = 1e-5         # f32 accumulation over 5 blocks of 128 per row
INT8_VS_F64 = 5e-2        # per-block int8 quantization: |err| <= max|U|/254
ALIGN_MIN = 0.9           # stop-selected iterate vs the true signal
SYM_INT8_VS_BANDED = 5e-2  # xhat of int8 sym vs f32 banded (quantization)
MESH_VS_ONE_CARD = 1e-3   # f32 xhat1 over 3 iterations, other summation order


def check(ok, what):
    if not ok:
        raise AssertionError(what)


def rel(a, b):
    a = np.asarray(a, np.float64)
    b = np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / (np.linalg.norm(b) + 1e-300))


def phase(name):
    """Decorator: print the phase's wall time; a failure propagates."""
    def wrap(fn):
        def run(*a, **k):
            print(f"== {name}", flush=True)
            t0 = time.time()
            out = fn(*a, **k)
            print(f"== {name}: ok in {time.time() - t0:.1f} s", flush=True)
            return out
        return run
    return wrap


def gen_band_files(K=1):
    """gen-band through its CLI, cached in .biobank/."""
    from sgvamp.cli import simulate

    prefix = os.path.join(DATA, f"smoke_M{M}_bw{BW}_K{K}")
    if not os.path.exists(prefix + "_R.npz"):
        os.makedirs(DATA, exist_ok=True)
        simulate.main(["gen-band", "--out", prefix, "--N", str(N_SAMPLES),
                       "--M", str(M), "--h2", str(H2), "--lam", str(LAM),
                       "--bandwidth", str(BW), "--seed", "0", "--K", str(K),
                       "--uncompressed"])
    return prefix


def load_band(prefix):
    from sgvamp.data import loaders

    band, bw, dropped = loaders.csr_to_band(loaders.load_R(prefix + "_R.npz"), BW)
    check(bw == BW and dropped == 0, "band extraction")
    return band


def host_band_matvec(upper, scales, x):
    """float64 host matvec over (nb, hb+1, B, B) upper blocks; x (M,)."""
    nb, hbp1, Bk, _ = upper.shape
    xb = x.reshape(nb, Bk)
    y = np.zeros_like(xb)
    for d in range(hbp1):
        U = upper[:nb - d, d].astype(np.float64)
        if scales is not None:
            U = U * scales[:nb - d, d, None, None]
        y[:nb - d] += np.einsum("npq,nq->np", U, xb[d:])
        if d:
            y[d:] += np.einsum("npq,np->nq", U, xb[:nb - d])
    return y.reshape(-1)


@phase("1 kernel parity at M=524288")
def kernel_parity(band):
    import jax.numpy as jnp

    from sgvamp.data.simulate import band_matvec
    from sgvamp.ops.band_kernel import SymBandedLD

    K, S = 2, 2
    x = np.random.default_rng(1).normal(size=(S * K, M)).astype(np.float32)
    for dtype in (None, "int8"):
        op = SymBandedLD.from_band(band, block_size=B, K=K, dtype=dtype)
        yk = np.asarray(dataclasses.replace(op, impl="kernel").matvec(jnp.asarray(x)))
        yr = np.asarray(dataclasses.replace(op, impl="reference").matvec(jnp.asarray(x)))
        check(np.all(np.isfinite(yk)) and yk.shape == x.shape, "kernel output")
        e_ref = rel(yk, yr)
        up = np.asarray(op.upper[0])
        sc = None if op.scales is None else np.asarray(op.scales[0])
        e_deq = max(rel(yk[j], host_band_matvec(up, sc, x[j].astype(np.float64)))
                    for j in range(S * K))
        e_f64 = max(rel(yk[j], band_matvec(band, x[j].astype(np.float64)))
                    for j in range(S * K))
        bound = F32_VS_F64 if dtype is None else INT8_VS_F64
        name = dtype or "float32"
        print(f"  {name}: kernel vs reference {e_ref:.3e} (bound {KERNEL_VS_REF:g}); "
              f"vs f64 host on the stored blocks {e_deq:.3e} (bound {F32_VS_F64:g}); "
              f"vs f64 host band {e_f64:.3e} (bound {bound:g})", flush=True)
        check(e_ref <= KERNEL_VS_REF, f"{name} kernel vs reference")
        check(e_deq <= F32_VS_F64, f"{name} kernel vs f64 on stored blocks")
        check(e_f64 <= bound, f"{name} kernel vs f64 band")
        del op


@phase("1b kernel parity past 2 GiB of int8 blocks: K=8, M=1048576")
def kernel_parity_xl(band):
    """K=8 cohorts over a M=1,048,576 panel (two copies of the M=524,288
    panel on the diagonal) hold 3.2 GB of int8 blocks: element offsets
    past 2**31. Each cohort's blocks are rolled by its own number of block
    rows, so a read from another cohort's blocks shows."""
    import jax.numpy as jnp

    from sgvamp.ops.band_kernel import SymBandedLD

    K, S = 8, 2
    one = SymBandedLD.from_band(np.concatenate([band, band]), block_size=B,
                                dtype="int8")
    op = SymBandedLD(
        upper=jnp.stack([jnp.roll(one.upper[0], 37 * k, axis=0) for k in range(K)]),
        scales=jnp.stack([jnp.roll(one.scales[0], 37 * k, axis=0)
                          for k in range(K)]))
    del one
    check(op.upper.nbytes > 2**31, "int8 blocks past 2 GiB")
    x = np.random.default_rng(4).normal(size=(S * K, op.M)).astype(np.float32)
    yk = np.asarray(dataclasses.replace(op, impl="kernel").matvec(jnp.asarray(x)))
    yr = np.asarray(dataclasses.replace(op, impl="reference").matvec(jnp.asarray(x)))
    check(np.all(np.isfinite(yk)) and yk.shape == x.shape, "kernel output")
    e_ref = [rel(yk[j::K], yr[j::K]) for j in range(K)]
    up, sc = np.asarray(op.upper[K - 1]), np.asarray(op.scales[K - 1])
    rows = range(K - 1, S * K, K)
    e_deq = max(rel(yk[j], host_band_matvec(up, sc, x[j].astype(np.float64)))
                for j in rows)
    print(f"  {op.upper.nbytes} B of int8 blocks; kernel vs reference per cohort "
          f"{['%.3e' % e for e in e_ref]} (bound {KERNEL_VS_REF:g}); cohort {K - 1} "
          f"vs f64 host on the stored blocks {e_deq:.3e} (bound {F32_VS_F64:g})",
          flush=True)
    check(max(e_ref) <= KERNEL_VS_REF, "xl kernel vs reference")
    check(e_deq <= F32_VS_F64, "xl kernel vs f64 on stored blocks")


def cli_argv(prefix, out_dir, name, iterations, extra):
    return ["--ld-files", prefix + "_R.npz", "--r-files", prefix + "_r.npy",
            "--true-signal-file", prefix + "_bet.npy",
            "--out-dir", out_dir, "--out-name", name,
            "--N", str(N_SAMPLES), "--M", str(M),
            "--iterations", str(iterations),
            "--prior-probs", "0.99,0.01", "--prior-vars", "0,0.000133537",
            "--block-size", str(B), "--bandwidth", str(BW),
            "--cg-maxit", "500", "--cg-rtol", "1e-5", "--cg-precond-block", "64",
            "--cg-precond-dtype", "bfloat16", "--lmmse-damp", "1", "--rho", "0.5",
            *extra]


def read_outputs(out_dir, name):
    """Reference-format outputs of one CLI run: {it: xhat}, alignments."""
    from sgvamp.io.writers import read_bin

    params = open(os.path.join(out_dir, f"{name}_cohort_1.csv")).read().split("\n")
    check(params[0].split("\t") == ["it", "gamw", "gam1", "gam2", "alpha1",
                                    "alpha2", "lam"], "cohort CSV header")
    rows = [r.split("\t") for r in params[1:] if r]
    check(rows and all(len(r) == 7 and np.all(np.isfinite(np.float64(r)))
                       for r in rows), "cohort CSV rows finite")
    metrics = open(os.path.join(out_dir, f"{name}_metrics.csv")).read().split("\n")
    check(metrics[0].split("\t") == ["it", "alignment", "l2"], "metrics CSV header")
    aligns = [float(r.split("\t")[1]) for r in metrics[1:] if r]
    xhats = {}
    for path in glob.glob(os.path.join(out_dir, f"{name}_xhat_it_*.bin")):
        it = int(path.rsplit("_", 1)[1][:-4])
        xhats[it] = read_bin(path)
        check(xhats[it].shape == (M,) and np.all(np.isfinite(xhats[it])),
              f"xhat bin {it}")
    check(len(xhats) == len(rows) == len(aligns), "one output per iteration")
    return xhats, aligns


@phase("2 production CLI run (sym, int8, M=524288)")
def cli_run(prefix, out_dir):
    from sgvamp.cli import main as cli
    from sgvamp.core.vamp import alignment_l2
    from sgvamp.io.writers import read_bin

    argv = cli_argv(prefix, out_dir, "bb", 5,
                    ["--operator", "sym", "--ld-dtype", "int8",
                     "--stop-on-divergence", "1"])
    t0 = time.time()
    check(cli.main(argv) == 0, "cli exit code")
    print(f"  CLI wall time {time.time() - t0:.1f} s (ingest + compile + "
          f"inference + outputs)", flush=True)
    xhats, aligns = read_outputs(out_dir, "bb")
    print(f"  alignment per iteration {aligns}", flush=True)
    best = read_bin(os.path.join(out_dir, "bb_xhat_best.bin"))
    x0 = np.load(prefix + "_bet.npy").reshape(-1)
    align_best = alignment_l2(best, x0)[0]
    print(f"  stop-selected alignment {align_best:.6f} (bound >= {ALIGN_MIN})",
          flush=True)
    check(np.all(np.isfinite(best)) and align_best >= ALIGN_MIN,
          "stop-selected alignment")
    return xhats


@phase("3 cross-check against --operator banded (f32, plain XLA)")
def banded_cross_check(prefix, out_dir, sym_xhats):
    from sgvamp.cli import main as cli

    check(cli.main(cli_argv(prefix, out_dir, "banded", 2,
                            ["--operator", "banded"])) == 0, "cli exit code")
    xhats, aligns = read_outputs(out_dir, "banded")
    print(f"  banded alignment per iteration {aligns}", flush=True)
    for it in sorted(xhats):
        check(it in sym_xhats, f"sym run has iteration {it}")
        e = rel(sym_xhats[it], xhats[it])
        print(f"  iteration {it}: sym int8 vs banded f32 xhat {e:.3e} "
              f"(bound {SYM_INT8_VS_BANDED:g})", flush=True)
        check(e <= SYM_INT8_VS_BANDED, f"sym vs banded at iteration {it}")


def _engine_inputs(op, r, K):
    import jax.numpy as jnp

    from sgvamp import PriorState, VampConfig, VampInputs

    cm = max(int(M * LAM), 1)
    cfg = VampConfig(prior_update="em", dtype="float32", cg_maxit=100,
                     cg_force_maxiter=True, em_prior_maxit=5, rho=0.5,
                     lmmse_damp=True)
    prior = PriorState.create(LAM, [1.0], [H2 / cm * N_SAMPLES])
    inputs = VampInputs(op=op, r=jnp.asarray(np.broadcast_to(r, (K, M)), jnp.float32),
                        a=jnp.full((K,), 1.0 / K, jnp.float32),
                        N=jnp.full((K,), float(N_SAMPLES), jnp.float32))
    return inputs, cfg, prior


@phase("4 fixed-budget step and per-pass matvec times")
def fixed_budget(band, r, peak_gbps):
    import jax
    import jax.numpy as jnp

    from bench import per_pass_seconds, read_probe_seconds
    from sgvamp.core import vamp as V
    from sgvamp.core.operators import BandedLD
    from sgvamp.ops.band_kernel import SymBandedLD

    sym8 = SymBandedLD.from_band(band, block_size=B, dtype="int8")
    print(f"  fixed budget: cg_maxit=100 forced, 102 LD passes per iteration, "
          f"{sym8.bytes_per_pass()} B/pass", flush=True)
    for impl in ("kernel", "reference"):
        inputs, cfg, prior = _engine_inputs(
            dataclasses.replace(sym8, impl=impl), r, 1)
        step = jax.jit(lambda s, i: V.vamp_step(s, i, cfg, None))
        state = V.init_state(inputs, cfg, prior, gamw=5.0, gam1=1e-6)
        t0 = time.time()
        state, _ = jax.block_until_ready(step(state, inputs))
        compile_s = time.time() - t0
        n = 5
        t0 = time.perf_counter()
        for _ in range(n):
            state, aux = step(state, inputs)
        jax.block_until_ready(state)
        ms = (time.perf_counter() - t0) / n * 1e3
        check(bool(jnp.all(jnp.isfinite(state.xhat2))), f"{impl} step finite")
        print(f"  step sym int8 {impl}: {ms:.3f} ms/iteration "
              f"({ms / 102:.4f} ms per LD pass incl. CG vector work), "
              f"first call {compile_s:.1f} s", flush=True)
        del inputs, state

    def report(label, op, K):
        x = jnp.asarray(np.random.default_rng(2).normal(size=(2 * K, M)),
                        jnp.float32)
        s = per_pass_seconds(lambda o, v: o.matvec(v) * 0.02, op, x)
        gbps = op.bytes_per_pass() / s / 1e9
        print(f"  matvec {label} K={K}: {s * 1e3:.4f} ms/pass, "
              f"{op.bytes_per_pass()} B/pass, {gbps:.1f} GB/s "
              f"({gbps / peak_gbps:.3f} of {peak_gbps:g})", flush=True)

    for K in (1, 8):
        s8 = SymBandedLD.from_band(band, block_size=B, K=K, dtype="int8")
        for impl in ("kernel", "reference"):
            report(f"sym int8 {impl}", dataclasses.replace(s8, impl=impl), K)
        if K == 1:
            t = read_probe_seconds(s8.upper)
            gbps = s8.upper.nbytes / t / 1e9
            print(f"  plain read of the int8 blocks: {t * 1e3:.4f} ms, "
                  f"{gbps:.1f} GB/s ({gbps / peak_gbps:.3f} of {peak_gbps:g})",
                  flush=True)
            sf = SymBandedLD.from_band(band, block_size=B, K=K)
            for impl in ("kernel", "reference"):
                report(f"sym f32 {impl}", dataclasses.replace(sf, impl=impl), K)
            del sf
        del s8
        for dt in ("bfloat16", "float32"):
            bl = BandedLD.from_band(band, block_size=B, K=K, dtype=dt)
            report(f"banded {dt}", bl, K)
            del bl


@phase("four cards: K=4 cohorts on (4,1) and (1,4) meshes")
def four_cards(M_=M, iters=3, impl=None):
    import jax
    import jax.numpy as jnp

    from sgvamp import PriorState, VampConfig, VampEngine, VampInputs
    from sgvamp.data.simulate import simulate_ld_band
    from sgvamp.ops.band_kernel import SymBandedLD
    from sgvamp.parallel.sharding import make_mesh

    K = 4
    check(len(jax.devices()) >= K, f"need {K} devices")
    band, r, _ = simulate_ld_band(N_SAMPLES, M_, BW, h2=H2, lam=LAM,
                                  rng=np.random.default_rng(0),
                                  dtype=np.float32, n_r=K)
    op = dataclasses.replace(
        SymBandedLD.from_band(band, block_size=B, K=K, dtype="int8"), impl=impl)
    cm = max(int(M_ * LAM), 1)
    cfg = VampConfig(prior_update="em", dtype="float32", cg_maxit=50,
                     cg_force_maxiter=True, em_prior_maxit=5, rho=0.5,
                     lmmse_damp=True)
    prior = PriorState.create(LAM, [1.0], [H2 / cm * N_SAMPLES])
    inputs = VampInputs(op=op, r=jnp.asarray(r, jnp.float32),
                        a=jnp.full((K,), 1.0 / K, jnp.float32),
                        N=jnp.full((K,), float(N_SAMPLES), jnp.float32))
    u = (np.random.default_rng(3).integers(0, 2, size=(iters, K, op.M)) * 2
         - 1).astype(np.float32)
    t0 = time.time()
    one = VampEngine(inputs, cfg, prior).run(iters, fixed_u=u)
    print(f"  one card: {time.time() - t0:.1f} s", flush=True)
    for shape in ((4, 1), (1, 4)):
        t0 = time.time()
        got = VampEngine(inputs, cfg, prior, mesh=make_mesh(*shape)).run(
            iters, fixed_u=u)
        errs = [rel(got["xhat1"][it], one["xhat1"][it]) for it in range(iters)]
        print(f"  mesh (cohort, shard)={shape}: xhat1 vs one card {errs} "
              f"(bound {MESH_VS_ONE_CARD:g}), {time.time() - t0:.1f} s", flush=True)
        check(all(np.isfinite(errs)) and max(errs) <= MESH_VS_ONE_CARD,
              f"mesh {shape} vs one card")


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--four-cards", action="store_true",
                   help="run only the 4-card mesh phase")
    args = p.parse_args(argv)

    import jax

    dev = jax.devices()[0]
    if dev.platform != "gpu":
        print(f"chip_smoke: no GPU (JAX found {dev.platform}); nothing run",
              file=sys.stderr)
        return 2
    from sgvamp.utils.compile_cache import enable_compile_cache

    enable_compile_cache()
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout
    print(f"nvidia-smi: {smi.strip()}")
    print(f"jax {jax.__version__}: {len(jax.devices())} x {dev.device_kind}",
          flush=True)

    if args.four_cards:
        four_cards()
    else:
        from bench import hbm_peak_gbps

        peak = hbm_peak_gbps(dev.device_kind)
        prefix = gen_band_files()
        band = load_band(prefix)
        kernel_parity(band)
        kernel_parity_xl(band)
        out_dir = os.path.join(DATA, "smoke_out")
        shutil.rmtree(out_dir, ignore_errors=True)
        sym_xhats = cli_run(prefix, out_dir)
        banded_cross_check(prefix, out_dir, sym_xhats)
        fixed_budget(band, np.load(prefix + "_r.npy"), peak)
    print(json.dumps({"ok": True, "device": {"platform": dev.platform,
                                             "kind": dev.device_kind,
                                             "count": len(jax.devices())}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
