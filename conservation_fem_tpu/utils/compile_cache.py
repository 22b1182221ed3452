"""Where JAX keeps its persistent compile cache.

One rule for every entry point (bench.py, chip_smoke.py, the CLI and
__graft_entry__): when ``JAX_COMPILATION_CACHE_DIR`` is set, JAX reads it
itself and nothing is set here; otherwise the cache lives at the fixed
``<checkout>/.jax_cache`` (listed in .gitignore). The path is part of the
cache key, so it never depends on a temporary name, a process id or the
time.
"""

from __future__ import annotations

import os

ENV_VAR = "JAX_COMPILATION_CACHE_DIR"
DEFAULT_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(
        __file__)))), ".jax_cache")


def enable_compile_cache() -> str:
    """Turn on the persistent compile cache; returns the directory in use."""
    env = os.environ.get(ENV_VAR)
    if env:
        return env
    import jax

    os.makedirs(DEFAULT_DIR, exist_ok=True)
    jax.config.update("jax_compilation_cache_dir", DEFAULT_DIR)
    jax.config.update("jax_persistent_cache_min_compile_time_secs", 1.0)
    return DEFAULT_DIR
