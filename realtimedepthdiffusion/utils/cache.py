"""Persistent XLA compilation cache for the product surfaces.

The reference binary pays no startup compile (CUDA kernels ship compiled,
src/GPUSolver.cu); a JAX process pays the full-cascade XLA compile per image
shape on every cold start. The persistent compilation cache makes every
surface (CLI, GUI, serving) start from disk after the first run.

Where: ``JAX_COMPILATION_CACHE_DIR`` when it is set — JAX reads that
variable itself, and no other directory is set in code — otherwise the fixed
path ``<checkout>/.jax_cache`` (git-ignored). Opt out with
RTDD_NO_COMPILE_CACHE=1.
"""

from __future__ import annotations

import os

CHECKOUT_CACHE_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))),
    ".jax_cache",
)


def cache_dir() -> str:
    """The compile cache directory this process uses (module docstring)."""
    return os.environ.get("JAX_COMPILATION_CACHE_DIR") or CHECKOUT_CACHE_DIR


def enable_compilation_cache() -> str | None:
    """Turn on the persistent compilation cache; returns its directory, or
    None when RTDD_NO_COMPILE_CACHE opts out. Failures raise."""
    if os.environ.get("RTDD_NO_COMPILE_CACHE", "").lower() not in ("", "0", "false"):
        return None
    import jax

    cache = cache_dir()
    if not os.environ.get("JAX_COMPILATION_CACHE_DIR"):
        os.makedirs(cache, exist_ok=True)
        jax.config.update("jax_compilation_cache_dir", cache)
    return cache
