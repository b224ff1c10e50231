"""Persistent XLA compilation cache setup (shared by CLI, API, and bench).

Where ``JAX_COMPILATION_CACHE_DIR`` is set, JAX reads it itself and this
module sets nothing.  Otherwise the cache lives at one fixed path inside
the checkout, ``<repo>/.jax_cache`` (git ignores it): the path is part of
what JAX keys the cache on, so a directory that moved would never hit."""

from __future__ import annotations

import os

CACHE_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))),
    ".jax_cache",
)


def enable_compilation_cache() -> None:
    import jax

    if not os.environ.get("JAX_COMPILATION_CACHE_DIR"):
        try:
            jax.config.update("jax_compilation_cache_dir", CACHE_DIR)
        except Exception:
            return  # the cache is an optimization; never fail the run over it
    jax.config.update("jax_persistent_cache_min_compile_time_secs", 0.5)
