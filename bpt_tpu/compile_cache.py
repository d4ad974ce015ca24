"""Where JAX keeps its persistent compilation cache.

A renderer process compiles the same wavefront programs on every start;
the persistent cache turns later compiles into loads.  Its directory is
part of the cache key, so it must not move between runs.
"""
from __future__ import annotations

import os

ENV = "JAX_COMPILATION_CACHE_DIR"
# <checkout>/.jax_cache: fixed whatever the working directory, gitignored.
DEFAULT_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.abspath(__file__))), ".jax_cache")


def enable_compile_cache() -> str:
    """Point JAX's persistent compilation cache at a fixed directory and
    return it.  When JAX_COMPILATION_CACHE_DIR is set, JAX reads it itself
    and nothing is set here; otherwise the cache is DEFAULT_DIR."""
    env = os.environ.get(ENV)
    if env:
        return env
    import jax

    jax.config.update("jax_compilation_cache_dir", DEFAULT_DIR)
    return DEFAULT_DIR
