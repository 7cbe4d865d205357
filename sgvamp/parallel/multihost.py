"""Multi-host initialization and cross-host mesh construction.

The reference runs one MPI rank per cohort over whatever MPI the cluster
provides, moving pickled Python objects (reference src/main.py:16-18,
README.md:7-11). The equivalent here is jax.distributed: one process per
host, with the global device mesh laid out so the cohort axis spans hosts
and the shard axis stays inside each host - the layout that keeps every
per-CG-iteration collective on the host's own interconnect and only the
cheap per-iteration (gam1, r1) combine crossing hosts.

Single-host runs need none of this; multihost_init is a no-op when no
coordinator address is configured.
"""

from __future__ import annotations

import logging
import os
from typing import Optional

import jax
import numpy as np
from jax.sharding import Mesh

from sgvamp.parallel.sharding import COHORT_AXIS, SHARD_AXIS

logger = logging.getLogger("sgvamp")


def multihost_init(
    coordinator_address: Optional[str] = None,
    num_processes: Optional[int] = None,
    process_id: Optional[int] = None,
) -> bool:
    """Initialize jax.distributed if configured; returns True if multi-host.

    Args may come from flags or the standard JAX_COORDINATOR_ADDRESS /
    JAX_NUM_PROCESSES / JAX_PROCESS_ID environment; without a coordinator
    address this is a single-process run.

    On the CPU backend, cross-process collectives need a collectives
    implementation; gloo is selected automatically (it ships with jaxlib)
    unless the user already configured one. This is what makes the
    multi-process CPU test harness (tests/test_multiprocess.py) — and any
    CPU-cluster deployment — work at all.
    """
    coordinator_address = coordinator_address or os.environ.get("JAX_COORDINATOR_ADDRESS")
    if not coordinator_address:
        return False
    if jax.config.jax_platforms and "cpu" in str(jax.config.jax_platforms):
        try:
            jax.config.update("jax_cpu_collectives_implementation", "gloo")
        except Exception:  # already initialized or unsupported jaxlib
            pass
    kwargs = {"coordinator_address": coordinator_address}
    if num_processes is not None:
        kwargs["num_processes"] = num_processes
    if process_id is not None:
        kwargs["process_id"] = process_id
    jax.distributed.initialize(**kwargs)
    logger.info(
        f"jax.distributed initialized: process {jax.process_index()}/{jax.process_count()}"
    )
    return True


def fetch_global(x):
    """Bring a (possibly cross-process-sharded) jax.Array to host numpy.

    Single-process arrays pass straight through np.asarray. A multi-process
    global array is first resharded to fully-replicated (an XLA all-gather;
    this must be called collectively on every process, which the SPMD
    engine loop guarantees) and then read from the local shard. This is
    what lets the host-side I/O loop (engine.run) work unchanged under
    jax.distributed, replacing the reference's per-rank file writes
    (reference src/sgvamp.py:281-283)."""
    if not hasattr(x, "is_fully_addressable") or x.is_fully_addressable:
        return np.asarray(x)
    if x.sharding.is_fully_replicated:
        return np.asarray(x.addressable_shards[0].data)
    from jax.sharding import NamedSharding, PartitionSpec as P

    mesh = x.sharding.mesh
    rep = jax.jit(lambda a: a, out_shardings=NamedSharding(mesh, P()))(x)
    return np.asarray(rep.addressable_shards[0].data)


def make_multihost_mesh(n_cohort: Optional[int] = None) -> Mesh:
    """Global (cohort, shard) mesh with the cohort axis across hosts.

    Defaults the cohort axis to the process (host) count, so each host's
    local devices form one shard group and the block-sharded CG matvec
    collectives stay on that host.
    """
    n_proc = jax.process_count()
    n_dev = jax.device_count()
    if n_cohort is None:
        n_cohort = n_proc
    if n_dev % n_cohort:
        raise ValueError(f"{n_dev} devices not divisible into {n_cohort} cohorts")
    n_shard = n_dev // n_cohort
    # jax.devices() is globally consistent and host-major: devices of
    # process p occupy the contiguous range [p*local, (p+1)*local) - so a
    # (n_cohort, n_shard) reshape puts whole hosts in single cohort rows
    # whenever n_cohort divides the process count.
    arr = np.asarray(jax.devices()).reshape(n_cohort, n_shard)
    return Mesh(arr, (COHORT_AXIS, SHARD_AXIS))
