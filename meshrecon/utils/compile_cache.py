"""Persistent XLA compilation cache placement, shared by every entry point.

The fused update compiles for tens of seconds on a GPU, so repeated runs
should find it in the cache. The cache key includes the cache path, so the
path must not move between runs.
"""

from __future__ import annotations

import os
from pathlib import Path

ENV_VAR = "JAX_COMPILATION_CACHE_DIR"
# fixed, gitignored, inside the checkout (next to the package)
DEFAULT_DIR = Path(__file__).resolve().parents[2] / ".jax_cache"


def enable_compile_cache() -> str:
    """Turn the persistent compilation cache on and return its directory.

    When ``JAX_COMPILATION_CACHE_DIR`` is set, jax reads it itself and this
    sets no path; otherwise the cache goes to ``DEFAULT_DIR``."""
    import jax

    jax.config.update("jax_persistent_cache_min_compile_time_secs", 1.0)
    env = os.environ.get(ENV_VAR)
    if env:
        return env
    jax.config.update("jax_compilation_cache_dir", str(DEFAULT_DIR))
    return str(DEFAULT_DIR)
