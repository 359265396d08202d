"""Persistent XLA compile cache.

The analogue of the reference's shader binary cache (ShaderManager disk
cache + metadata, ShaderManager.cpp:410-416): compiled frame programs
persist across processes, so a second process that builds the same
pipeline skips its compile.

Where ``JAX_COMPILATION_CACHE_DIR`` is set, JAX already uses that directory
and this module sets none. Otherwise the cache lives at the fixed
``<repo>/.jax_cache`` (gitignored): the path is part of the cache key, so a
directory that moves never hits. Call before the first compile.
"""

from __future__ import annotations

import os

DEFAULT_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))),
    ".jax_cache",
)


def enable_compile_cache() -> str:
    """Turn the persistent cache on; returns the directory in use."""
    import jax

    d = os.environ.get("JAX_COMPILATION_CACHE_DIR")
    if not d:
        d = DEFAULT_DIR
        os.makedirs(d, exist_ok=True)
        jax.config.update("jax_compilation_cache_dir", d)
    jax.config.update("jax_persistent_cache_min_compile_time_secs", 0.5)
    return d
