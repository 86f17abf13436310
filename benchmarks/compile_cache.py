"""Where JAX's persistent compilation cache lives.

``$JAX_COMPILATION_CACHE_DIR`` when it is set, and no other directory;
otherwise the fixed ``<checkout>/.jax_cache`` (the path is part of the
cache key, so it must not move between runs).  This module imports no JAX
at its top level, so a parent process that only launches children can ask
for the path without touching the card.
"""

from __future__ import annotations

import os

CHECKOUT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def compile_cache_dir() -> str:
    return (os.environ.get("JAX_COMPILATION_CACHE_DIR")
            or os.path.join(CHECKOUT, ".jax_cache"))


def enable_compile_cache() -> str:
    """Point this process's JAX at :func:`compile_cache_dir`, caching every
    compiled program; returns the directory."""
    import jax

    path = compile_cache_dir()
    jax.config.update("jax_compilation_cache_dir", path)
    jax.config.update("jax_persistent_cache_min_entry_size_bytes", -1)
    jax.config.update("jax_persistent_cache_min_compile_time_secs", 0.0)
    return path
