"""JAX's persistent compilation cache, in one place.

Where JAX_COMPILATION_CACHE_DIR is set, JAX reads it itself and this
module sets no path. Otherwise the cache lives at one fixed directory
inside the checkout (`.jax_cache/`, git-ignored): the path is part of
what makes a later process hit the cache, so it must not move.
"""

from __future__ import annotations

import os
from pathlib import Path

import jax

CACHE_DIR = Path(__file__).resolve().parents[2] / ".jax_cache"


def enable_compile_cache() -> str:
    """Turn the persistent cache on; returns the directory in use."""
    env = os.environ.get("JAX_COMPILATION_CACHE_DIR")
    if env:
        return env
    jax.config.update("jax_compilation_cache_dir", str(CACHE_DIR))
    jax.config.update("jax_persistent_cache_min_compile_time_secs", 1.0)
    return str(CACHE_DIR)
