"""Persistent compile cache for the entry points (CLI, bench, smoke check).

Library imports set nothing; an entry point calls ``enable_compile_cache``
once before its first compile. If ``JAX_COMPILATION_CACHE_DIR`` is set,
JAX already reads it and nothing is set here. Otherwise the cache goes to
``.jax_cache/`` at the checkout root: a fixed path, since the path is part
of what makes a later run find the entries again.
"""

from __future__ import annotations

import os
from typing import Optional

import jax

CHECKOUT_ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))


def enable_compile_cache(root: Optional[str] = None) -> str:
    """Return the cache directory in use, setting it if the environment
    does not (``root`` defaults to the checkout holding this package)."""
    env = os.environ.get("JAX_COMPILATION_CACHE_DIR")
    if env:
        return env
    path = os.path.join(root or CHECKOUT_ROOT, ".jax_cache")
    jax.config.update("jax_compilation_cache_dir", path)
    return path
