"""Persistent XLA compilation cache, shared by the CLI and the bench.

JAX keys its cache by directory path, so the path is fixed: a directory
that moves between runs never hits.
"""

from __future__ import annotations

import os

# <checkout>/.cache/jax (.cache/ is gitignored)
CACHE_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(
        __file__)))),
    ".cache", "jax",
)


def enable_compile_cache() -> str:
    """Turn on JAX's persistent compilation cache; returns its directory.

    Where JAX_COMPILATION_CACHE_DIR is set, JAX reads it itself and
    nothing is set here.  Otherwise the cache lives at CACHE_DIR."""
    env = os.environ.get("JAX_COMPILATION_CACHE_DIR")
    if env:
        return env
    import jax

    os.makedirs(CACHE_DIR, exist_ok=True)
    jax.config.update("jax_compilation_cache_dir", CACHE_DIR)
    jax.config.update("jax_persistent_cache_min_compile_time_secs", 0.5)
    return CACHE_DIR
