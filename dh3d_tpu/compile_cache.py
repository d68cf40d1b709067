"""JAX's persistent compilation cache for the entry points.

A cache is keyed by its path, so it only hits when the path is stable:
`JAX_COMPILATION_CACHE_DIR` when the environment sets it (JAX reads the
variable itself), otherwise `.jax_cache` at the root of the checkout.
The CPU test suite does not call this.
"""

from __future__ import annotations

import os

ENV_VAR = "JAX_COMPILATION_CACHE_DIR"
DEFAULT_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.abspath(__file__))), ".jax_cache")


def enable_compile_cache() -> str:
    """Turn the persistent cache on; returns its directory."""
    if os.environ.get(ENV_VAR):
        return os.environ[ENV_VAR]
    import jax

    jax.config.update("jax_compilation_cache_dir", DEFAULT_DIR)
    return DEFAULT_DIR
