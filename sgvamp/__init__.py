"""sgvamp: a gVAMP engine for GWAS summary statistics in JAX.

A from-scratch JAX/XLA rebuild of the capabilities of
medical-genomics-group/sgVAMP-py:
spike-and-slab mixture denoising + conjugate-gradient LMMSE over the MxM LD
matrix, with Onsager corrections, damping, Hutchinson trace estimation,
noise-precision learning and EM/MLE prior learning across K cohorts.

Design (see SURVEY.md section 7): the entire VAMP iteration is one pure,
jit-compiled function over a named-axis device mesh ("cohort", "shard");
the LD matrix is block-sharded so each CG matvec is a local block matmul
plus neighbour exchanges, and the K-cohort axis maps data-parallel.
Hosts only do I/O.
"""

from sgvamp.config import PriorConfig, VampConfig
from sgvamp.core.cg import cg_batched
from sgvamp.core.denoiser import combine_cohorts, posterior_mean_and_slope
from sgvamp.core.operators import BandedLD, DenseLD
from sgvamp.core.prior import PriorState, em_loop, em_update, mle_update
from sgvamp.core.vamp import (StopMonitor, VampEngine, VampInputs,
                              VampState, vamp_step)

__version__ = "0.1.0"

__all__ = [
    "PriorConfig",
    "VampConfig",
    "cg_batched",
    "combine_cohorts",
    "posterior_mean_and_slope",
    "DenseLD",
    "BandedLD",
    "PriorState",
    "em_update",
    "em_loop",
    "mle_update",
    "StopMonitor",
    "VampEngine",
    "VampInputs",
    "VampState",
    "vamp_step",
]
