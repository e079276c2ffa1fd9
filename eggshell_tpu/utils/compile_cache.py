"""JAX's persistent compilation cache, at one fixed place.

If `JAX_COMPILATION_CACHE_DIR` is set, JAX uses it and nothing here
changes.  Otherwise the cache goes to `<checkout>/.jax_cache`: a fixed
path, so every process of one checkout (tests, bench.py, chip_smoke.py)
finds what the others compiled.
"""

from __future__ import annotations

import os

import jax

CHECKOUT = os.path.dirname(
    os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
)


def enable_compile_cache() -> str:
    """Turn the cache on; returns its directory."""
    env = os.environ.get("JAX_COMPILATION_CACHE_DIR")
    if env:
        return env
    path = os.path.join(CHECKOUT, ".jax_cache")
    jax.config.update("jax_compilation_cache_dir", path)
    return path
