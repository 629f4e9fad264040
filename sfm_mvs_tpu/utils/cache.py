"""Persistent XLA compilation cache.

SIFT, RANSAC, the LM solver and MVS compile for tens of seconds each; with
JAX's persistent cache a rerun of the same shapes loads them from disk.
Entry points (the CLI, bench.py, chip_smoke.py, examples, benchmarks)
call :func:`enable` once before their first jit; tests do not.
"""

from __future__ import annotations

import os

# Fixed, inside the checkout: the path is part of what JAX keys on, so a
# directory that moved between runs would never hit.
DEFAULT_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))),
    ".jax_cache",
)


def enable(min_compile_secs: float = 1.0) -> str:
    """Turn the cache on and return its directory.

    $JAX_COMPILATION_CACHE_DIR when it is set, else DEFAULT_DIR.
    """
    import jax

    cache_dir = os.environ.get("JAX_COMPILATION_CACHE_DIR") or DEFAULT_DIR
    os.makedirs(cache_dir, exist_ok=True)
    jax.config.update("jax_compilation_cache_dir", cache_dir)
    jax.config.update("jax_persistent_cache_min_compile_time_secs", min_compile_secs)
    return cache_dir
