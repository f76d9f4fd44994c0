"""Set-up shared by the repository's entry points (scripts, tools, tests).

The library itself configures no compilation cache and picks no device;
entry points call :func:`enable_compile_cache` before their first
compilation, and measurement scripts call :func:`require_gpu`.
"""

from __future__ import annotations

import os

REPO_CACHE_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))),
    ".jax_cache",
)


def enable_compile_cache() -> str:
    """Return the cache directory in use. ``JAX_COMPILATION_CACHE_DIR``,
    when set, is honoured as JAX reads it and nothing is set here;
    otherwise the cache goes to the fixed ``<repo>/.jax_cache``."""
    env = os.environ.get("JAX_COMPILATION_CACHE_DIR")
    if env:
        return env
    import jax

    jax.config.update("jax_compilation_cache_dir", REPO_CACHE_DIR)
    jax.config.update("jax_persistent_cache_min_entry_size_bytes", -1)
    jax.config.update("jax_persistent_cache_min_compile_time_secs", 0.0)
    return REPO_CACHE_DIR


def require_gpu():
    """JAX's first device; raises RuntimeError unless it is a GPU (a
    measurement never falls back to the CPU)."""
    import jax

    dev = jax.devices()[0]
    if dev.platform != "gpu":
        raise RuntimeError(
            f"no GPU: JAX's first device is {dev.platform} ({dev.device_kind})"
        )
    return dev
