"""Where JAX keeps its persistent compilation cache.

Every entry point calls `enable()` once, before its first compile. When
`JAX_COMPILATION_CACHE_DIR` is set, JAX reads it itself and nothing is set
here. Otherwise the cache goes to a fixed directory in the repository, so
the same program finds its compiled code again from any working
directory (the path is part of the cache's key).
"""
from __future__ import annotations

import os

import jax

REPO_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ENV_VAR = "JAX_COMPILATION_CACHE_DIR"


def enable(dirname: str = ".jax_cache", min_compile_secs: float = 1.0) -> str:
    """Turn the cache on and return its directory. `dirname` (relative to
    the repository root) applies only when `JAX_COMPILATION_CACHE_DIR` is
    unset."""
    path = os.environ.get(ENV_VAR)
    if not path:
        path = os.path.join(REPO_ROOT, dirname)
        jax.config.update("jax_compilation_cache_dir", path)
    jax.config.update("jax_persistent_cache_min_compile_time_secs",
                      min_compile_secs)
    return path
