"""Test configuration: 8 virtual CPU devices + float64.

The reference validates nothing (no tests exist, SURVEY.md section 4); this
suite builds the pyramid it lacks. Multi-device logic is exercised on a
virtual 8-device CPU mesh, and numerics run in float64 to compare against
the float64 numpy/scipy oracle.

Tests marked `gpu` need the card and skip elsewhere; on a GPU machine run
them with `SGVAMP_TEST_GPU=1 python -m pytest tests/ -m gpu`, which leaves
JAX on its default platform.

Note: jax may be pre-imported by the harness before env vars can take
effect, so the CPU platform is forced via jax.config, not JAX_PLATFORMS.
"""

import os

import jax
import pytest

if os.environ.get("SGVAMP_TEST_GPU") != "1":
    jax.config.update("jax_platforms", "cpu")
    jax.config.update("jax_num_cpu_devices", 8)
jax.config.update("jax_enable_x64", True)


@pytest.fixture
def gpu():
    """Skip unless JAX runs on a GPU (decided here, never at import)."""
    if jax.devices()[0].platform != "gpu":
        pytest.skip("needs a GPU: SGVAMP_TEST_GPU=1 python -m pytest tests/ -m gpu")
