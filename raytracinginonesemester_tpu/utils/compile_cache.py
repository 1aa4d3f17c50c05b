"""Persistent XLA compile cache location, shared by every entry point."""

from __future__ import annotations

import os
import pathlib

import jax

__all__ = ["enable_compile_cache"]

# a fixed path inside the checkout (listed in .gitignore): the cache key
# includes the directory, so it must not move between runs
_DEFAULT_DIR = pathlib.Path(__file__).resolve().parents[2] / ".jax_cache"


def enable_compile_cache(min_compile_secs: float = 1.0) -> str:
    """Turn on JAX's persistent compile cache and return its directory:
    ``JAX_COMPILATION_CACHE_DIR`` when set, else ``.jax_cache`` at the
    root of the checkout."""
    path = os.environ.get("JAX_COMPILATION_CACHE_DIR") or str(_DEFAULT_DIR)
    jax.config.update("jax_compilation_cache_dir", path)
    jax.config.update("jax_persistent_cache_min_compile_time_secs",
                      min_compile_secs)
    return path
