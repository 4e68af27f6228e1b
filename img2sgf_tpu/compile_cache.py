"""Placement of JAX's persistent compile cache.

Every entry point (CLI, bench, tools, tests, chip_smoke.py) calls
enable_compile_cache() before its first compile, so all of them share one
cache: image sizes recur, and each canvas bucket's program takes long to
compile cold.
"""

from __future__ import annotations

import os
import pathlib

import jax

# Fixed path at the checkout root (listed in .gitignore): the cache key
# includes nothing of the path, but a directory that moves never hits.
DEFAULT_CACHE_DIR = pathlib.Path(__file__).resolve().parents[1] / ".jax_cache"


def enable_compile_cache() -> str:
    """Turn on the persistent compile cache and return its directory.

    Where JAX_COMPILATION_CACHE_DIR is set, JAX already reads it and this
    sets no other directory; otherwise the cache goes to .jax_cache/ at
    the checkout root.
    """
    if not os.environ.get("JAX_COMPILATION_CACHE_DIR"):
        jax.config.update("jax_compilation_cache_dir", str(DEFAULT_CACHE_DIR))
    jax.config.update("jax_persistent_cache_min_compile_time_secs", 1.0)
    return jax.config.jax_compilation_cache_dir
