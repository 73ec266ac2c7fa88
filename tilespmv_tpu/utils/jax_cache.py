"""Persistent compilation cache location.

Where `JAX_COMPILATION_CACHE_DIR` is set, JAX reads it itself and this
module sets nothing. Otherwise the cache goes to `<checkout>/.cache/jax`,
a fixed path: the path is part of the cache key, so a directory named
after a temporary file, a pid or the time would never hit.
"""
from __future__ import annotations

import os
import pathlib

import jax

ENV_VAR = "JAX_COMPILATION_CACHE_DIR"
DEFAULT_DIR = pathlib.Path(__file__).resolve().parents[2] / ".cache" / "jax"


def configure_compile_cache() -> str:
    """Point JAX's persistent compilation cache at its directory and
    return that directory. Call before the first compilation."""
    env = os.environ.get(ENV_VAR)
    if env:
        return env
    DEFAULT_DIR.mkdir(parents=True, exist_ok=True)
    jax.config.update("jax_compilation_cache_dir", str(DEFAULT_DIR))
    jax.config.update("jax_persistent_cache_min_compile_time_secs", 0.5)
    jax.config.update("jax_persistent_cache_enable_xla_caches", "all")
    return str(DEFAULT_DIR)
