"""Persistent XLA compile cache setup.

The full-pipeline program takes long to compile cold; a persistent cache
loads it in seconds on later runs. The rule:

- ``JAX_COMPILATION_CACHE_DIR`` set: JAX reads it itself, and nothing
  here overrides it or sets any other directory;
- unset: the cache lives at a fixed ``<checkout>/.jax_cache`` (listed in
  ``.gitignore``). The path is part of the cache key, so it must not move
  between runs.
"""

from __future__ import annotations

import os
from pathlib import Path

__all__ = ["CHECKOUT_CACHE_DIR", "enable_compile_cache"]

CHECKOUT_CACHE_DIR = Path(__file__).resolve().parents[2] / ".jax_cache"


def enable_compile_cache(min_compile_secs: float = 1.0) -> str:
    """Point JAX at the persistent compile cache; returns its directory."""
    configured = os.environ.get("JAX_COMPILATION_CACHE_DIR")
    if configured:
        return configured
    import jax

    CHECKOUT_CACHE_DIR.mkdir(parents=True, exist_ok=True)
    jax.config.update("jax_compilation_cache_dir", str(CHECKOUT_CACHE_DIR))
    jax.config.update("jax_persistent_cache_min_compile_time_secs",
                      float(min_compile_secs))
    return str(CHECKOUT_CACHE_DIR)
