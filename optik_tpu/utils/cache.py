"""Where JAX keeps its persistent compilation cache for this package."""

from __future__ import annotations

import os
import pathlib

import jax

# <checkout>/.jax_cache: a fixed path (it is part of the cache key, so a
# directory that moves never hits), listed in .gitignore.
CACHE_DIR = pathlib.Path(__file__).resolve().parents[2] / ".jax_cache"


def enable_compile_cache(min_compile_secs: float = 2.0) -> str:
    """Turn on the persistent compilation cache; return its directory.

    When ``JAX_COMPILATION_CACHE_DIR`` is set, JAX reads it itself and this
    sets nothing.  Otherwise the cache lives at ``CACHE_DIR`` and keeps
    executables that took at least ``min_compile_secs`` to compile.
    """
    env = os.environ.get("JAX_COMPILATION_CACHE_DIR")
    if env:
        return env
    jax.config.update("jax_compilation_cache_dir", str(CACHE_DIR))
    jax.config.update("jax_persistent_cache_min_compile_time_secs",
                      min_compile_secs)
    return str(CACHE_DIR)
