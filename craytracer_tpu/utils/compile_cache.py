"""Persistent compilation cache placement, shared by the entry points
(render.py, bench.py, chip_smoke.py)."""

from __future__ import annotations

import os

import jax

# The cache key includes the directory, so the default never moves: a
# fixed directory at the repository root (listed in .gitignore).
DEFAULT_CACHE_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(
        __file__)))), ".jax_cache")


def enable_compile_cache() -> str:
    """Turn on JAX's persistent compilation cache and return its
    directory. When JAX_COMPILATION_CACHE_DIR is set, JAX already uses it
    and nothing is changed here; otherwise the cache goes to
    DEFAULT_CACHE_DIR."""
    env = os.environ.get("JAX_COMPILATION_CACHE_DIR")
    if env:
        return env
    jax.config.update("jax_compilation_cache_dir", DEFAULT_CACHE_DIR)
    return DEFAULT_CACHE_DIR
