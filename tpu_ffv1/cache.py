"""JAX's persistent compile cache for the program's entry points.

``JAX_COMPILATION_CACHE_DIR`` names the directory when it is set;
otherwise the cache lives at ``<repo>/.jax_cache``, a fixed path (the
path is part of each entry's key, so a moving directory never hits).
"""
from __future__ import annotations

import os

ENV = "JAX_COMPILATION_CACHE_DIR"
DEFAULT_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
    ".jax_cache")


def cache_dir() -> str:
    """The directory the compile cache uses."""
    return os.environ.get(ENV) or DEFAULT_DIR


def enable_compile_cache(min_compile_secs: float | None = None) -> str:
    """Point JAX's persistent compile cache at cache_dir() and return
    it.  ``min_compile_secs`` overrides JAX's threshold for what is
    worth caching."""
    import jax
    path = cache_dir()
    jax.config.update("jax_compilation_cache_dir", path)
    if min_compile_secs is not None:
        jax.config.update("jax_persistent_cache_min_compile_time_secs",
                          min_compile_secs)
    return path
