"""Where the persistent XLA compilation cache lives.

JAX reads JAX_COMPILATION_CACHE_DIR by itself; when it is set, nothing here
sets another directory. Otherwise the cache goes to `.jax_cache` in the
checkout (gitignored), unless the caller names a directory.
"""

from __future__ import annotations

import os
from typing import Optional

CHECKOUT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))


def resolve_cache_dir(explicit: Optional[str] = None) -> Optional[str]:
    """The directory to configure, or None to leave JAX's setting alone.

    explicit: a directory named by the user ('' disables the cache)."""
    if explicit is not None:
        return os.path.expanduser(explicit) or None
    if os.environ.get("JAX_COMPILATION_CACHE_DIR"):
        return None
    return os.path.join(CHECKOUT, ".jax_cache")


def enable_compile_cache(explicit: Optional[str] = None) -> Optional[str]:
    """Configure JAX's persistent cache (before the first compile);
    returns the directory set in code, if any."""
    import jax

    cache_dir = resolve_cache_dir(explicit)
    if cache_dir is None:
        return None
    os.makedirs(cache_dir, exist_ok=True)
    jax.config.update("jax_compilation_cache_dir", cache_dir)
    jax.config.update("jax_persistent_cache_min_compile_time_secs", 1.0)
    jax.config.update("jax_persistent_cache_min_entry_size_bytes", -1)
    return cache_dir
