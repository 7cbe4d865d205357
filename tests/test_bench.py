"""bench.py smoke tests: the step child at the small size on the CPU
(SGVAMP_BENCH_PLATFORM=cpu asks for it explicitly), the refusal to
measure without a GPU, the peak table and the read probe."""

import json
import os
import subprocess
import sys

import numpy as np
import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def test_bench_step_child_small_cpu(tmp_path):
    env = dict(os.environ)
    env.update(
        SGVAMP_BENCH_CHILD="step",
        SGVAMP_BENCH_SIZE="small",
        SGVAMP_BENCH_PLATFORM="cpu",
    )
    out = subprocess.run(
        [sys.executable, os.path.join(REPO, "bench.py")],
        env=env, capture_output=True, text=True, timeout=420, cwd=REPO,
    )
    lines = [l for l in out.stdout.splitlines() if l.startswith("{")]
    assert lines, f"no JSON from bench child: {out.stderr[-500:]}"
    got = json.loads(lines[-1])
    assert got["finite"] is True
    assert got["iter_s_samples"], "step child must report per-block samples"
    assert all(s > 0 for s in got["iter_s_samples"])


def test_bench_step_child_reports_stop_fields(tmp_path):
    """The step child's quality gate runs the engine's StopMonitor and
    must report the auto-selected iterate's alignment (the headline
    quality number) alongside the post-hoc best."""
    env = dict(os.environ)
    env.update(
        SGVAMP_BENCH_CHILD="step",
        SGVAMP_BENCH_SIZE="small",
        SGVAMP_BENCH_PLATFORM="cpu",
    )
    out = subprocess.run(
        [sys.executable, os.path.join(REPO, "bench.py")],
        env=env, capture_output=True, text=True, timeout=420, cwd=REPO,
    )
    lines = [l for l in out.stdout.splitlines() if l.startswith("{")]
    assert lines, f"no JSON from bench child: {out.stderr[-500:]}"
    got = json.loads(lines[-1])
    for key in ("align_stop", "stop_it", "stop_reason", "align_best"):
        assert key in got
    # on the small panel the monitor's truth-free selection must land on
    # (essentially) the same iterate the post-hoc truth-peak finds
    assert got["align_stop"] > 0.95
    assert got["align_stop"] >= got["align_best"] - 0.02
    # timing blocks restart from the it=1 snapshot: state stays finite
    # regardless of how the gate trajectory ends
    assert got["finite"] is True


def test_bench_child_without_gpu_exits_nonzero():
    """No SGVAMP_BENCH_PLATFORM and no GPU: the child refuses to measure
    (non-zero exit, no JSON) instead of falling back to the CPU."""
    env = dict(os.environ)
    env.pop("SGVAMP_BENCH_PLATFORM", None)
    env.update(SGVAMP_BENCH_CHILD="matvec", SGVAMP_BENCH_SIZE="small",
               JAX_PLATFORMS="cpu")
    out = subprocess.run(
        [sys.executable, os.path.join(REPO, "bench.py")],
        env=env, capture_output=True, text=True, timeout=300, cwd=REPO,
    )
    assert out.returncode != 0
    assert not [l for l in out.stdout.splitlines() if l.startswith("{")]
    assert "refusing to measure" in out.stderr


def test_hbm_peak_table_knows_h100():
    import bench

    assert bench.hbm_peak_gbps("NVIDIA H100 80GB HBM3") == 3350.0


def test_hbm_peak_table_unknown_device_raises():
    import bench

    with pytest.raises(KeyError, match="no published memory bandwidth"):
        bench.hbm_peak_gbps("NVIDIA A100-SXM4-40GB")


def test_read_probe_and_per_pass_timing_cpu():
    """The timing helpers run and return positive seconds (a CPU number,
    checked for plumbing only)."""
    import jax.numpy as jnp

    import bench

    u = jnp.asarray(np.arange(4096, dtype=np.int8).reshape(64, 64))
    assert bench.read_probe_seconds(u, n=2, reps=1) > 0
    x = jnp.ones((2, 64), jnp.float32)
    s = bench.per_pass_seconds(lambda a, v: (a.astype(jnp.float32) @ v.T).T * 0.01,
                               u, x, n=2, reps=1)
    assert s > 0
