"""JAX's persistent compilation cache, in one place.

When JAX_COMPILATION_CACHE_DIR is set, JAX reads it itself and nothing is
set here.  Otherwise the cache lives at the fixed path <checkout>/.jax_cache
(listed in .gitignore): the path is part of the cache key, so it must not
move between runs.
"""

from __future__ import annotations

import os
from pathlib import Path

CHECKOUT_CACHE = Path(__file__).resolve().parents[2] / ".jax_cache"


def enable_compile_cache() -> str:
    """Turn on the persistent cache; return its directory."""
    env = os.environ.get("JAX_COMPILATION_CACHE_DIR")
    if env:
        return env
    import jax

    jax.config.update("jax_compilation_cache_dir", str(CHECKOUT_CACHE))
    return str(CHECKOUT_CACHE)
