"""Genuine multi-process execution test: 2 jax.distributed processes x 4
virtual CPU devices each, running the full VAMP engine over a cross-process
(cohort, shard) mesh built by make_multihost_mesh, with trajectory parity
against a single-device run asserted inside each child.

This is the CPU-cluster analogue of the reference's `mpirun -np K` launch
(reference src/main.py:16-18, README.md:6-12): one process per host, gloo
collectives standing in for the interconnect.
"""

import os
import socket
import subprocess
import sys

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CHILD = os.path.join(REPO, "tests", "multiproc_child.py")


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def test_two_process_mesh_parity():
    port = _free_port()
    env = dict(os.environ)
    env["PYTHONPATH"] = REPO + os.pathsep + env.get("PYTHONPATH", "")
    # the children pick their own platform/device config; scrub any
    # conflicting hints from the parent
    env.pop("XLA_FLAGS", None)
    env.pop("JAX_PLATFORMS", None)
    procs = [
        subprocess.Popen(
            [sys.executable, CHILD, str(pid), "2", str(port)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
            env=env, cwd=REPO,
        )
        for pid in range(2)
    ]
    outs = []
    try:
        for p in procs:
            out, _ = p.communicate(timeout=540)
            outs.append(out)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
    for pid, (p, out) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, (
            f"process {pid} failed (rc={p.returncode}):\n{out[-4000:]}")
        # the einsum operator, the flagship sym pallas shard_map kernel
        # (halo/spill ppermutes over gloo), AND its int8-quantized flavor
        # (per-block scales leaf sharded across processes) must all pass
        assert f"PARITY OK operator=banded process={pid}" in out
        assert f"PARITY OK operator=sym process={pid}" in out
        assert f"PARITY OK operator=sym_int8 process={pid}" in out


def test_multihost_init_noop_without_config(monkeypatch):
    """Single-host runs must not require any of this: multihost_init is a
    no-op without a coordinator address (flag or env)."""
    monkeypatch.delenv("JAX_COORDINATOR_ADDRESS", raising=False)
    from sgvamp.parallel.multihost import multihost_init

    assert multihost_init() is False
