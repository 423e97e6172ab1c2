"""Where the program keeps what it caches between runs: inside the checkout.

`JAX_COMPILATION_CACHE_DIR`, when set, owns JAX's persistent compile cache
and nothing here overrides it. Otherwise the cache lives at a fixed path in
the checkout (`.cache/jax`, listed in `.gitignore`): the path is part of
the cache's key, so a directory that moved between runs would never hit.
"""

from __future__ import annotations

import os

REPO_ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
CACHE_ROOT = os.path.join(REPO_ROOT, ".cache")

_ENV = "JAX_COMPILATION_CACHE_DIR"


def compile_cache_dir() -> str:
    """The directory JAX's persistent compile cache uses."""
    return os.environ.get(_ENV) or os.path.join(CACHE_ROOT, "jax")


def enable_compile_cache(min_compile_secs: float = 1.0) -> str:
    """Turn on the persistent compile cache for programs that take at
    least `min_compile_secs` to compile; returns its directory."""
    import jax

    path = compile_cache_dir()
    if not os.environ.get(_ENV):
        jax.config.update("jax_compilation_cache_dir", path)
    jax.config.update("jax_persistent_cache_min_compile_time_secs",
                      min_compile_secs)
    return path
