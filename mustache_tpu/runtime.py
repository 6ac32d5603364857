"""Process-level runtime setup shared by the CLIs and benchmarks."""

from __future__ import annotations

import os

# One fixed cache home inside the checkout (listed in .gitignore): the
# path is part of what a later process must find again, so it never
# depends on HOME, a temp name, a pid or the time.
DEFAULT_CACHE_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.abspath(__file__))), ".jax_cache")


def enable_compilation_cache() -> str | None:
    """Persist XLA compilations across processes; returns the directory.

    Where ``JAX_COMPILATION_CACHE_DIR`` is set, JAX already reads it and
    nothing is changed here. Otherwise the cache lives at
    :data:`DEFAULT_CACHE_DIR`. The cache is a pure optimization: an
    unwritable checkout must not crash CLI startup (returns None).
    """
    env = os.environ.get("JAX_COMPILATION_CACHE_DIR")
    if env:
        return env
    import jax

    try:
        os.makedirs(DEFAULT_CACHE_DIR, exist_ok=True)
        jax.config.update("jax_compilation_cache_dir", DEFAULT_CACHE_DIR)
    except OSError:
        return None
    return DEFAULT_CACHE_DIR
