"""Persistent XLA compilation cache location.

`JAX_COMPILATION_CACHE_DIR`, when set, is honoured by JAX itself and no
other path is set here.  Otherwise the cache goes to `.jax_cache/` at the
root of the checkout: a fixed path, because the path is part of the cache
key, so a cache whose directory moves never hits.
"""

from __future__ import annotations

import os

CHECKOUT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
DEFAULT_DIR = os.path.join(CHECKOUT, ".jax_cache")


def enable_compile_cache() -> str:
    """Point JAX's persistent compilation cache at its directory and return
    that directory."""
    env = os.environ.get("JAX_COMPILATION_CACHE_DIR")
    if env:
        return env
    import jax

    jax.config.update("jax_compilation_cache_dir", DEFAULT_DIR)
    return DEFAULT_DIR
