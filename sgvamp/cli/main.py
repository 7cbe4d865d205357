"""sgVAMP driver CLI.

Flag-compatible with the reference driver (reference src/main.py:27-51):
same flag names, defaults, and value semantics (including the
bool(int(...)) parsing of --lmmse-damp / --learn-gamw, src/main.py:69-70),
so existing invocations port by dropping `mpirun -np K` - all K cohorts run
inside one jit-compiled program on the device mesh instead of K MPI ranks.

Deliberate fixes over the reference (SURVEY quirks ledger):
  #2 --bim-files is genuinely optional: without it all cohorts must share
     the same marker panel (the natural .npy/.npz workflow); the reference
     crashes on None.
  #3 --mle-prior-update (README name) is accepted as an alias of
     --prior-update.
  #6 output files are created exactly once (single driver process).

Flags beyond the reference are grouped under "execution".
"""

from __future__ import annotations

import argparse
import logging
import os
import sys
import time
from typing import List, Optional

import numpy as np



def _pad_band(band: "np.ndarray", bw: int) -> "np.ndarray":
    """Center symmetric band storage (M, 2w+1) inside (M, 2bw+1) at the
    shared bandwidth bw (returns the input unchanged when already there)."""
    w = (band.shape[1] - 1) // 2
    if w == bw:
        return band
    full = np.zeros((band.shape[0], 2 * bw + 1), band.dtype)
    full[:, bw - w:bw + w + 1] = band
    return full


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description="VAMP for summary statistics (JAX)")
    # -- reference-compatible surface (src/main.py:27-51) --
    p.add_argument("-ld_files", "--ld-files", help="Path to LD matrices (.npz/.npy/.ld), separated by comma")
    p.add_argument("-r_files", "--r-files", help="Path to XTy files (.txt/.npy/.linear) separated by comma")
    p.add_argument("-true_signal_file", "--true-signal-file", help="Path to true signal .npy/.bin file", default=None)
    p.add_argument("-out_dir", "--out-dir", help="Output directory")
    p.add_argument("-out_name", "--out-name", help="Output file name")
    p.add_argument("-N", "--N", help="Number of samples in each cohort, separated by comma")
    p.add_argument("-M", "--M", help="Number of markers in each cohort, separated by comma")
    p.add_argument("-K", "--K", help="Number of cohorts", default=1)
    p.add_argument("-L", "--L", help="Number of prior mixture components", default=2)
    p.add_argument("-iterations", "--iterations", help="Number of iterations", default=10)
    p.add_argument("-prior_vars", "--prior-vars", help="Prior mixture variances", default="0,1")
    p.add_argument("-prior_probs", "--prior-probs", help="Prior mixture probabilities", default="0.99,0.01")
    p.add_argument("-gamw", "--gamw", help="Initial noise precision", default=5)
    p.add_argument("-gam1", "--gam1", help="Initial signal precision", default=0.000001)
    p.add_argument("-lmmse_damp", "--lmmse-damp", help="Use LMMSE damping", default=False)
    p.add_argument("-learn_gamw", "--learn-gamw", help="Learn or fix gamw", default=True)
    p.add_argument("-rho", "--rho", help="Damping factor rho", default=0.5)
    p.add_argument("-cg_maxit", "--cg-maxit", help="CG max iterations", default=500)
    p.add_argument("-s", "--s", help="Rused = (1-s) * R + s * Id", default=0.0)
    p.add_argument("-prior_update", "--prior-update", "--mle-prior-update",
                   dest="prior_update", help="Prior learning: 'em', 'mle' or 'none'", default="em")
    p.add_argument("-update_prior_from", "--update-prior-from",
                   help="Learn prior probabilities from this iteration onwards", default=1)
    p.add_argument("-em_prior_maxit", "--em-prior-maxit",
                   help="Max prior-learning EM iterations", default=100)
    p.add_argument("-bim_files", "--bim-files", help="Paths to .bim files, separated by comma", default=None)
    # -- execution --
    g = p.add_argument_group("execution")
    g.add_argument("--platform", help="JAX platform override (gpu/cpu)", default=None)
    g.add_argument("--x64", help="Enable float64 (1/0); default on for CPU, off for GPU", default=None)
    g.add_argument("--dtype", help="Compute dtype: float32/float64/bfloat16", default=None)
    g.add_argument("--ld-dtype", help="LD block storage dtype (bfloat16 halves the "
                   "device-memory footprint; int8 with per-block scales, sym "
                   "operator only, halves it again; matvecs accumulate in "
                   "float32); defaults to --dtype",
                   default=None)
    g.add_argument("--mesh-cohort", help="Mesh size over the cohort axis", type=int, default=1)
    g.add_argument("--mesh-shard", help="Mesh size over the marker-shard axis", type=int, default=None)
    g.add_argument("--operator", default="dense",
                   choices=["dense", "banded", "sym", "blocksparse"],
                   help="LD operator: dense, banded (block-banded einsum), sym "
                   "(upper-triangle blocks only, a Pallas kernel on the GPU; "
                   "(hb+1)/(2hb+1) of banded's bytes), "
                   "or blocksparse (arbitrary block coordinates - keeps "
                   "long-range/out-of-band LD entries that banded/sym drop)")
    g.add_argument("--block-size", help="Banded operator block size", type=int, default=256)
    g.add_argument("--bandwidth", help="Banded operator half bandwidth (elements); auto if omitted",
                   type=int, default=None)
    g.add_argument("--cg-rtol", help="CG relative tolerance", type=float, default=1e-5)
    g.add_argument("--cg-precond-block", type=int, default=0,
                   help="Block-Jacobi CG preconditioner sub-block size "
                   "(0 = off; must divide --block-size). Cuts CG iterations "
                   "~2x on banded LD at the default rtol")
    g.add_argument("--cg-precond-dtype", default="float32",
                   help="Preconditioner inverse-block storage dtype "
                   "(bfloat16 halves its HBM traffic)")
    g.add_argument("--rho-final", help="Anneal damping linearly to this value",
                   type=float, default=None)
    g.add_argument("--rho-anneal-iters", help="Iterations over which rho anneals",
                   type=int, default=0)
    g.add_argument("--seed", help="PRNG seed for Hutchinson probes", type=int, default=0)
    g.add_argument("--clip-alpha1", default=0,
                   help="Clip alpha1 into [1e-5, 1-1e-5] (1/0). The clip the "
                   "reference INTENDED but discarded (its np.clip result is "
                   "unused, sgvamp.py:293); off by default for parity")
    g.add_argument("--clip-alpha2", default=0,
                   help="Clip alpha2 into [1e-5, 1-1e-5] (1/0). alpha2 is "
                   "provably in (0,1) for an SPD operator, so this only "
                   "removes Hutchinson/CG estimator noise; keeps gam1 "
                   "positive on near-noiseless panels where the unguarded "
                   "recursion (reference sgvamp.py:347) goes negative and "
                   "NaNs. Off by default for parity")
    g.add_argument("--gam-clamp", type=float, default=0.0,
                   help="Clamp gam1/gam2 into [1/x, x] (the standard VAMP "
                   "gamma_min/gamma_max guard; try 1e8). Extends the "
                   "finite horizon when iterating past convergence, where "
                   "the unguarded precision recursion grows geometrically "
                   "and overflows (the reference diverges the same way); "
                   "combine with early stopping. 0 = off (parity)")
    g.add_argument("--stop-tol", type=float, default=0.0,
                   help="Early-stop when the relative change of xhat1 "
                   "between iterations falls below this tolerance "
                   "(converged). 0 = off (reference parity: fixed "
                   "iteration count, post-hoc selection)")
    g.add_argument("--stop-on-divergence", default=0,
                   help="Early-stop when min-over-cohorts gam1 collapses "
                   "below its running peak by --stop-gam1-drop, or goes "
                   "non-finite (1/0). gVAMP destabilizes past its "
                   "operating point (the reference's fixed-count run "
                   "decays the same way and relies on post-hoc CSV "
                   "selection); this stops at the operating point and "
                   "reports the best iterate automatically. Off by "
                   "default for parity")
    g.add_argument("--stop-gam1-drop", type=float, default=10.0,
                   help="Divergence factor for --stop-on-divergence: "
                   "trigger when min_k gam1 < peak/this")
    g.add_argument("--fused", help="Run all iterations as one fused scan (1/0, no per-iteration output files)",
                   default=0)
    g.add_argument("--checkpoint-dir", help="Directory for checkpoint/resume state", default=None)
    g.add_argument("--checkpoint-every", type=int, default=10,
                   help="With --fused 1: run the scan in chunks of this many "
                   "iterations, checkpointing (and flushing outputs) between "
                   "chunks. The host loop (--fused 0) checkpoints every "
                   "iteration regardless")
    g.add_argument("--resume", help="Resume from the latest checkpoint (1/0)", default=0)
    g.add_argument("--profile-dir", help="Write a jax.profiler trace of the run here", default=None)
    g.add_argument("--compile-cache-dir", default=None,
                   help="Persistent XLA compilation cache directory ('' sets "
                   "none). Default: JAX_COMPILATION_CACHE_DIR when set, else "
                   ".jax_cache in the checkout")
    # -- multi-host execution (replaces the reference's `mpirun -np K`,
    #    reference src/main.py:16-18, README.md:6-12) --
    d = p.add_argument_group(
        "multi-host execution",
        "Run one process per host under jax.distributed; all processes get "
        "the same flags (the SPMD analogue of mpirun). Also honours the "
        "standard JAX_COORDINATOR_ADDRESS/JAX_NUM_PROCESSES/JAX_PROCESS_ID "
        "env vars.")
    d.add_argument("--coordinator-address", default=None,
                   help="host:port of process 0's coordinator service")
    d.add_argument("--num-processes", type=int, default=None,
                   help="Total number of processes (hosts)")
    d.add_argument("--process-id", type=int, default=None,
                   help="This process's id in [0, num-processes)")
    return p


def main(argv: Optional[List[str]] = None) -> int:
    args = build_parser().parse_args(argv)

    logging.basicConfig(format="%(message)s", level=logging.INFO)
    # DEBUG only for sgvamp's own phase/load timers: at a DEBUG root level
    # other libraries (the compile cache's file locks among them) flood
    # the log with thousands of lines per run
    log = logging.getLogger("sgvamp")
    log.setLevel(logging.DEBUG)
    log.info(" ### VAMP for summary statistics ###\n")

    # Resolve platform/precision before any jax array work.
    import jax

    if args.platform:
        jax.config.update("jax_platforms", args.platform)
        n_mesh = max(args.mesh_cohort, 1) * max(args.mesh_shard or 1, 1)
        if args.platform == "cpu" and n_mesh > 1:
            # provision virtual CPU devices for mesh testing (the CPU
            # analogue of a multi-chip slice); must precede backend init
            try:
                jax.config.update("jax_num_cpu_devices", n_mesh)
            except RuntimeError:
                pass
    from sgvamp.utils.compile_cache import enable_compile_cache
    enable_compile_cache(args.compile_cache_dir)
    # Multi-host bootstrap must run before the backend is touched
    # (jax.devices() below initializes it).
    from sgvamp.parallel.multihost import multihost_init
    is_multihost = multihost_init(args.coordinator_address,
                                  args.num_processes, args.process_id)
    is_driver = jax.process_index() == 0
    if not is_driver:
        # one driver process owns stdout and all output files (the
        # reference's all-ranks-recreate-CSVs race, SURVEY section 5,
        # removed by construction)
        logging.getLogger("sgvamp").setLevel(logging.WARNING)

    platform = jax.devices()[0].platform
    want_x64 = (platform == "cpu") if args.x64 is None else bool(int(args.x64))
    if want_x64:
        jax.config.update("jax_enable_x64", True)
    dtype = args.dtype or ("float64" if want_x64 else "float32")
    ld_dtype = args.ld_dtype or dtype
    if ld_dtype == "int8" and args.operator != "sym":
        # Only the sym operator carries dequantization scales; a plain cast
        # would truncate correlations in [-1, 1] to zero and silently
        # produce garbage.
        raise SystemExit(f"--ld-dtype {ld_dtype} requires --operator sym")

    import jax.numpy as jnp

    from sgvamp.config import PriorConfig, VampConfig
    from sgvamp.core.operators import BandedLD, DenseLD
    from sgvamp.core.prior import PriorState
    from sgvamp.core.vamp import VampEngine, VampInputs
    from sgvamp.data import harmonize as hz
    from sgvamp.data import loaders
    from sgvamp.io.writers import OutputWriter
    from sgvamp.utils.profiling import PhaseTimers, device_trace

    timers = PhaseTimers()

    # -- parse values with reference semantics (src/main.py:53-97) --
    for flag, val in [("--ld-files", args.ld_files), ("--r-files", args.r_files),
                      ("--N", args.N), ("--M", args.M)]:
        if not val:
            raise SystemExit(f"{flag} is required")
    K = int(args.K)
    L = int(args.L)
    iterations = int(args.iterations)
    gamw = float(args.gamw)
    gam1 = float(args.gam1)
    rho = float(args.rho)
    lmmse_damp = bool(int(args.lmmse_damp))
    learn_gamw = bool(int(args.learn_gamw))
    cg_maxit = int(args.cg_maxit)
    s = float(args.s)
    prior_update = None if args.prior_update in (None, "none", "") else args.prior_update
    update_prior_from = int(args.update_prior_from)
    em_prior_maxit = int(args.em_prior_maxit)

    ld_paths = args.ld_files.split(",")
    r_paths = args.r_files.split(",")
    N_list = [int(n) for n in args.N.split(",")]
    M_list = [int(m) for m in args.M.split(",")]
    prior_vars = [float(x) for x in args.prior_vars.split(",")]
    prior_probs = [float(x) for x in args.prior_probs.split(",")]

    if len(ld_paths) != K:
        raise SystemExit("Specified number of cohorts is not equal to number of LD matrices provided!")
    if len(r_paths) != K:
        raise SystemExit("Specified number of cohorts is not equal to number of marginal estimates provided!")
    if len(prior_vars) != L:
        raise SystemExit("Number of prior variances must be L!")
    if len(prior_probs) != L:
        raise SystemExit("Number of prior mixture probabilites must be L!")
    if len(N_list) == 1 and K > 1:
        N_list = N_list * K
    if len(M_list) == 1 and K > 1:
        M_list = M_list * K

    for key, val in sorted(vars(args).items()):
        log.info(f"--{key.replace('_', '-')} {val}")
    log.info("")

    Nt = float(sum(N_list))
    a = np.asarray(N_list, dtype=np.float64) / Nt

    # -- device mesh (decided before the LD operator so operator choice can
    #    react to sharding; replaces the reference's one-rank-per-cohort
    #    MPI layout, src/main.py:85) --
    mesh = None
    if is_multihost:
        from sgvamp.parallel.multihost import make_multihost_mesh
        mesh = make_multihost_mesh(args.mesh_cohort if args.mesh_cohort > 1 else None)
        log.info(f"Running on multi-host mesh "
                 f"{dict(zip(mesh.axis_names, mesh.devices.shape))} over "
                 f"{jax.process_count()} processes")
    elif args.mesh_cohort > 1 or args.mesh_shard:
        from sgvamp.parallel.sharding import make_mesh
        mesh = make_mesh(args.mesh_cohort, args.mesh_shard)
        log.info(f"Running on mesh {dict(zip(mesh.axis_names, mesh.devices.shape))}")
    # --operator sym under a mesh runs its matvec as a shard_map (halo +
    # mirror-spill ppermutes over the marker axis); shard_inputs pins the
    # mesh on the operator.

    # -- harmonization (reference src/main.py:126-165) --
    ts = time.time()
    timers.start("load/bim")
    if args.bim_files:
        bim_paths = args.bim_files.split(",")
        out_bim = os.path.join(args.out_dir, args.out_name + ".bim") if args.out_dir else None
        if out_bim:
            os.makedirs(args.out_dir, exist_ok=True)
        panel = hz.harmonize(bim_paths, N_list, out_bim)
    else:
        if len(set(M_list)) != 1:
            raise SystemExit("Without --bim-files all cohorts must share the same M")
        panel = hz.identity_panel(M_list[0], K)
    M = panel.M
    log.info(f"Total number of markers in reference is {M}")
    timers.stop("load/bim")
    log.debug(f"Handling .bim files took {time.time() - ts:.3f} seconds\n")

    # -- r vectors (reference src/main.py:176-194) --
    ts = time.time()
    timers.start("load/r")
    rs = []
    for k in range(K):
        r_local = loaders.load_r(r_paths[k], M_list[k], N_list[k])
        rs.append(loaders.scatter_to_reference(r_local, panel.i_maps[k], M))
    timers.stop("load/r")
    log.debug(f"Loading r vectors took {time.time() - ts:.3f} seconds\n")

    # -- LD matrices (reference src/main.py:199-263) --
    ts = time.time()
    timers.start("load/R")
    B = args.block_size
    all_ld_tables = all(p.endswith(".ld") for p in ld_paths)
    all_sparse = all(p.endswith((".ld", ".npz")) for p in ld_paths)
    banded_like = args.operator in ("banded", "sym")
    if banded_like and all_sparse:
        # Band-direct ingestion: .ld triplets (native parser) or sparse
        # .npz -> symmetric band storage -> block-banded operator, never
        # materializing MxM.
        dropped = 0
        # int8 quantizes at block-pack time (per-block scales inside
        # from_band); the staged band arrays must stay float.
        band_dtype = np.dtype(np.float32 if ld_dtype == "int8" else ld_dtype)
        if all_ld_tables:
            bands, rs_list, bw, dropped = loaders.ld_files_to_bands(
                ld_paths, rs, panel, args.bandwidth, dtype=band_dtype)
            rs = np.stack(rs_list)
            band_views = [bands[k] for k in range(K)]
            # the cross-cohort missing-SNP fill can make bands differ per
            # cohort even for identical paths: never share packs here
            pack_keys = list(range(K))
        else:
            # Load + convert each UNIQUE path once: the shared-panel
            # meta-analysis workflow (e.g. K=8 cohorts over one biobank
            # panel) lists the same file once per cohort, and 7/8 of
            # that XL run's ~8-minute ingestion was redundant re-loads.
            # Also skips the (K, M, 2bw+1) host stack (16 GB at the
            # ceiling) - cohorts reference the unique padded bands.
            uniq = {}
            for p in ld_paths:
                if p not in uniq:
                    uniq[p] = loaders.csr_to_band(
                        loaders.load_R(p), args.bandwidth, dtype=band_dtype)
            dropped = sum(d for _, _, d in uniq.values())
            bw = max(w for _, w, _ in uniq.values())
            band_views = [_pad_band(uniq[p][0], bw) for p in ld_paths]
            pack_keys = list(ld_paths)
            rs = np.stack(rs)
        if dropped:
            log.info(f"WARNING: {dropped} LD entries outside bandwidth {bw} dropped")
        # block-pack each unique band once; repeated cohorts reuse it
        pack_cache = {}

        def packed(k, ctor):
            key = pack_keys[k]
            if key not in pack_cache:
                pack_cache[key] = ctor(band_views[k], block_size=B, s=s,
                                       dtype=ld_dtype)
            return pack_cache[key]

        if args.operator == "sym":
            from sgvamp.ops.band_kernel import SymBandedLD
            ops = [packed(k, SymBandedLD.from_band) for k in range(K)]
            scales = (jnp.concatenate([o.scales for o in ops], axis=0)
                      if ops[0].scales is not None else None)
            op = SymBandedLD(upper=jnp.concatenate([o.upper for o in ops], axis=0),
                             scales=scales, s=s)
        else:
            ops = [packed(k, BandedLD.from_band) for k in range(K)]
            op = BandedLD(blocks=jnp.concatenate([o.blocks for o in ops], axis=0),
                          s=s, accum_dtype=ops[0].accum_dtype)
        Mp = ops[0].M
        pad = Mp - M
    else:
        vindex = {rs_: i for i, rs_ in enumerate(panel.variants)}
        Rs = [loaders.load_R(p, vindex) for p in ld_paths]
        if any(p.endswith(".ld") for p in ld_paths) and K > 1:
            # sparse-level fill: never materializes K M x M dense matrices
            Rs, rs = loaders.fill_missing_csr(Rs, rs, panel)
        rs = np.stack(rs)
        if args.operator == "blocksparse":
            # built from the CSRs directly - keeps every entry of any
            # sparsity pattern (the reference CSR path's capability,
            # src/main.py:251-257) without materializing M x M
            from sgvamp.core.operators import BlockSparseLD
            op = BlockSparseLD.from_csr(
                [loaders.as_csr(R, M) for R in Rs], block_size=B, s=s,
                dtype=np.dtype(ld_dtype), M=M)
            Mp = op.M
            pad = Mp - M
            log.info(f"Block-sparse LD: {op.nnzb} of {op.nb * op.nb} "
                     f"({op.B}x{op.B}) blocks stored")
        elif args.operator == "sym":
            # built from the CSRs directly - the dense stack is never needed
            # on this path (it would cost O(K*M^2) host memory at exactly
            # the large M the sym operator targets)
            from sgvamp.ops.band_kernel import SymBandedLD
            band_dtype = np.dtype(np.float32 if ld_dtype == "int8" else ld_dtype)
            bands_k, dropped = [], 0
            for R in Rs:
                band_k, _, d_k = loaders.csr_to_band(R, args.bandwidth,
                                                     dtype=band_dtype)
                bands_k.append(band_k)
                dropped += d_k
            bw = max((b.shape[1] - 1) // 2 for b in bands_k)
            if dropped:
                log.info(f"WARNING: {dropped} LD entries outside bandwidth {bw} dropped")
            ops = [SymBandedLD.from_band(_pad_band(b, bw), block_size=B,
                                         s=s, dtype=ld_dtype)
                   for b in bands_k]
            scales = (jnp.concatenate([o.scales for o in ops], axis=0)
                      if ops[0].scales is not None else None)
            op = SymBandedLD(upper=jnp.concatenate([o.upper for o in ops], axis=0),
                             scales=scales, s=s)
            Mp = ops[0].M
            pad = Mp - M
        elif args.operator == "banded":
            dense = loaders.to_dense_stack(Rs, M)
            bw = args.bandwidth
            if bw is None:
                bw = max(loaders.estimate_bandwidth(R) for R in Rs)
            pad = (-M) % B
            if pad:
                dense = np.pad(dense, ((0, 0), (0, pad), (0, pad)))
                for i in range(pad):  # keep padded diagonal SPD
                    dense[:, M + i, M + i] = 1.0
            hb = -(-(bw + B - 1) // B)
            op = BandedLD.from_dense(dense, block_size=B, bandwidth_blocks=hb,
                                     s=s, dtype=np.dtype(ld_dtype))
            Mp = dense.shape[-1]
        else:
            dense = loaders.to_dense_stack(Rs, M)
            op = DenseLD(mats=jnp.asarray(dense, ld_dtype), s=s,
                         accum_dtype="" if ld_dtype == "float64" else "float32")
            pad, Mp = 0, M
    log.info(f"Loaded {K} LD matrices of shape ({M}, {M})")
    timers.stop("load/R")
    log.debug(f"Loading R matrices took {time.time() - ts:.3f} seconds\n")

    # -- true signal (reference src/main.py:269-285; rank-0 N scaling) --
    x0 = None
    if args.true_signal_file:
        x0 = loaders.load_true_signal(args.true_signal_file, M, N_list[0])
        log.info(f"True signals loaded. Shape: {x0.shape}\n")

    # -- engine --
    cfg = VampConfig(
        rho=rho, cg_maxit=cg_maxit, cg_rtol=args.cg_rtol, learn_gamw=learn_gamw,
        lmmse_damp=lmmse_damp, prior_update=prior_update,
        update_prior_from=update_prior_from, em_prior_maxit=em_prior_maxit,
        dtype=dtype, rho_final=args.rho_final,
        rho_anneal_iters=args.rho_anneal_iters,
        cg_precond_block=args.cg_precond_block,
        cg_precond_dtype=args.cg_precond_dtype,
        clip_alpha1=bool(int(args.clip_alpha1)),
        clip_alpha2=bool(int(args.clip_alpha2)),
        gam_clamp=args.gam_clamp,
    )
    pc = PriorConfig(vars_=tuple(prior_vars), probs=tuple(prior_probs))
    prior = PriorState.create(pc.init_lam(), pc.init_omegas(), pc.scaled_sigmas(Nt))
    mask = None
    if pad:
        mask = jnp.asarray(np.concatenate([np.ones(M), np.zeros(pad)]), dtype)
    inputs = VampInputs(
        op=op,
        r=jnp.asarray(np.pad(rs, ((0, 0), (0, pad))) if pad else rs, dtype),
        a=jnp.asarray(a, dtype),
        N=jnp.asarray(N_list, dtype),
        mask=mask,
    )
    engine = VampEngine(inputs, cfg, prior, gamw=gamw, gam1=gam1, mesh=mesh)

    ckpt = None
    state = None
    start_it = 0
    if args.checkpoint_dir:
        from sgvamp.io.checkpoint import CheckpointManager
        ckpt = CheckpointManager(args.checkpoint_dir)
        if bool(int(args.resume)):
            restored = ckpt.restore_latest(engine.init_state(args.seed))
            if restored is not None:
                state, start_it = restored
                log.info(f"Resumed from checkpoint at iteration {start_it}")

    writer = None
    if args.out_dir and is_driver:
        writer = OutputWriter(args.out_dir, args.out_name, K, append=start_it > 0)

    log.info("...Running sgVAMP\n")
    stop_tol = float(args.stop_tol)
    stop_drop = (float(args.stop_gam1_drop)
                 if bool(int(args.stop_on_divergence)) else 0.0)
    ts = time.time()
    with device_trace(args.profile_dir), timers.phase("infer"):
        if bool(int(args.fused)):
            from sgvamp.core.vamp import StopMonitor, StopState
            from sgvamp.parallel.multihost import fetch_global

            # Armed stop criteria run IN-SCAN (StopState carried on device;
            # iterations past the stop take a lax.cond no-op branch, so the
            # fused run stops paying at the operating point — same
            # trajectory and selected iterate as the host loop). Unarmed
            # runs keep the plain scan + a host monitor that only tracks
            # the best iterate.
            armed = stop_tol > 0 or stop_drop > 0
            monitor = StopMonitor(tol=stop_tol, gam1_drop=stop_drop)

            def feed_monitor(aux, it0_chunk, n):
                """Track the best iterate over a fused chunk's stacked aux
                (host-side, between scans; unarmed path only)."""
                for i in range(n):
                    monitor.update(it0_chunk + i, np.asarray(aux.xhat1[i])[:M],
                                   np.asarray(aux.gam1[i]))

            def fetch_tree(t):
                if jax.process_count() > 1:
                    t = jax.tree_util.tree_map(fetch_global, t)
                return t

            mon_st = None
            ran_total = 0

            def run_chunk(n, st, mon_st):
                """Returns (state, gathered aux trimmed to the rows that
                actually executed, stop state, n_valid). The in-scan stop
                skips iterations past the stop; their all-zero aux rows
                are trimmed BEFORE the cross-process gather (n_ran is a
                replicated scalar) so nothing past the stop is moved
                between hosts, written to disk, or checkpointed."""
                nonlocal ran_total
                if st is None:
                    st = engine.init_state(args.seed)
                if armed:
                    st, aux, mon_st = engine.run_scan_stoppable(
                        n, stop_tol=stop_tol, stop_gam1_drop=stop_drop,
                        state=st, stop_state=mon_st)
                    n_valid = int(mon_st.n_ran) - ran_total
                    ran_total += n_valid
                    if n_valid < n:
                        aux = jax.tree_util.tree_map(lambda x: x[:n_valid],
                                                     aux)
                else:
                    st, aux = engine.run_scan(n, state=st)
                    n_valid = n
                return st, fetch_tree(aux), mon_st, n_valid

            if ckpt is not None:
                # Chunked fused checkpointing: lax.scan chunks of
                # --checkpoint-every iterations with a checkpoint (and an
                # output flush) between chunks. The trajectory is identical
                # to one long scan - the state (incl. the PRNG key) carries
                # across chunks, and so does the on-device stop monitor.
                every = max(1, int(args.checkpoint_every))
                st = state if state is not None else engine.init_state(args.seed)
                history = {"xhat1": [], "alignment": [], "l2": []}
                it = start_it
                while it < iterations:
                    n = min(every, iterations - it)
                    st, aux, mon_st, n_valid = run_chunk(n, st, mon_st)
                    if writer is not None and n_valid:
                        h = engine.write_scan_outputs(aux, writer, Nt=Nt,
                                                      x0=x0, M_out=M, it0=it)
                        for key in history:
                            history[key].extend(h.get(key, []))
                    elif n_valid:
                        history["xhat1"].extend(
                            np.asarray(aux.xhat1[i])[:M]
                            for i in range(n_valid))
                    ckpt.save(st, it + n_valid)
                    it += n_valid
                    if armed:
                        if bool(mon_st.done):
                            break
                    else:
                        feed_monitor(aux, it - n_valid, n_valid)
            else:
                final_state, aux, mon_st, n_valid = run_chunk(
                    iterations, None, None)
                if writer is not None:
                    history = engine.write_scan_outputs(aux, writer, Nt=Nt,
                                                        x0=x0, M_out=M)
                else:
                    history = {"xhat1": [np.asarray(aux.xhat1[i])[:M]
                                         for i in range(n_valid)]}
                if not armed:
                    feed_monitor(aux, 0, n_valid)
            if armed and mon_st is not None:
                mon_st = fetch_tree(mon_st)
                if bool(mon_st.done):
                    history["stopped_at"] = int(mon_st.stopped_at)
                    history["stop_reason"] = StopState.REASONS[
                        int(mon_st.reason)]
                best_it = int(mon_st.best_it)
                history["best_it"] = best_it
                history["best_xhat1"] = (np.asarray(mon_st.best_xhat1)
                                         if best_it >= 0 else None)
            elif armed:
                # resumed run already at/past its iteration count: no
                # chunk executed, nothing to select
                history["best_it"] = -1
                history["best_xhat1"] = None
            else:
                history["best_it"] = monitor.best_it
                history["best_xhat1"] = monitor.best_xhat1
        else:
            cb = None
            if ckpt is not None:
                cb = lambda it, st, aux: ckpt.save(st, it + 1)
            history = engine.run(
                iterations - start_it, state=state, writer=writer,
                x0=x0, Nt=Nt, seed=args.seed, callback=cb, M_out=M,
                it0=start_it, stop_tol=stop_tol, stop_gam1_drop=stop_drop,
            )
    log.info(f"sgVAMP inference running time: {time.time() - ts:0.4f}s\n")
    log.debug(timers.report())
    if history.get("stopped_at") is not None:
        log.info(f"Early stop at iteration {history['stopped_at']} "
                 f"({history['stop_reason']}); best iterate: "
                 f"iteration {history.get('best_it')}\n")
    # Persist the monitor-selected iterate (xhat1 at the running gam1
    # peak) whenever a stop criterion is armed: the deliverable of an
    # early-stopped run is a file, not a metrics-CSV row the user must
    # fish out post-hoc (the reference workflow, src/main.py:326-338).
    best_x = history.get("best_xhat1")
    if writer is not None and best_x is not None and (stop_tol > 0 or stop_drop > 0):
        from sgvamp.io.writers import write_bin
        best_path = os.path.join(args.out_dir,
                                 f"{args.out_name}_xhat_best.bin")
        # same 1/sqrt(Nt) scale as the per-iteration xhat bins (beta scale,
        # reference src/sgvamp.py:64-69)
        write_bin(best_path,
                  np.asarray(best_x)[:M] * (1.0 / np.sqrt(Nt) if Nt else 1.0))
        log.info(f"Selected iterate (iteration {history.get('best_it')}) "
                 f"written to {best_path}\n")

    # -- post-hoc metrics (reference src/main.py:326-338) --
    if x0 is not None and history.get("xhat1"):
        from sgvamp.core.vamp import alignment_l2
        x0v = x0.squeeze()
        aligns, l2s = [], []
        for xh in history["xhat1"]:
            al, l2 = alignment_l2(xh[:M], x0v)
            aligns.append(al)
            l2s.append(l2)
        log.info(f"Alignment(x1hat, x0) over iterations: \n {aligns}\n")
        log.info(f"L2 error(x1hat, x0) over iterations: \n {l2s}\n")
        bi = history.get("best_it", -1)
        if bi is not None and 0 <= bi - start_it < len(aligns):
            log.info(f"Selected iterate (gam1 peak): iteration {bi}, "
                     f"alignment {aligns[bi - start_it]:0.6f}, "
                     f"L2 {l2s[bi - start_it]:0.6f}\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
