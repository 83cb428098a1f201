"""Persistent XLA compilation cache for the entry points.

A cold run compiles the whole chain; the persistent cache keeps each
compiled executable on disk, keyed in part by the cache path, so the path
must not move between runs. If JAX_COMPILATION_CACHE_DIR is set, JAX
already reads it and this module sets nothing. Otherwise the cache goes
to a fixed directory inside the checkout (bench_cache/jax, gitignored).
"""

from __future__ import annotations

import os

import jax

DEFAULT_DIR = os.path.normpath(os.path.join(
    os.path.dirname(__file__), "..", "..", "bench_cache", "jax"))


def enable_compile_cache() -> str:
    """Point JAX's persistent compilation cache at its directory and
    return that directory. Call before the first compilation."""
    env = os.environ.get("JAX_COMPILATION_CACHE_DIR")
    if env:
        return env
    jax.config.update("jax_compilation_cache_dir", DEFAULT_DIR)
    return DEFAULT_DIR
