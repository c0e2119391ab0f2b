"""Persistent XLA compile cache: the one place that decides where it lives.

If `JAX_COMPILATION_CACHE_DIR` is set, JAX reads it itself and nothing is
set here.  Otherwise the cache goes to a fixed directory inside the
checkout, `<repo>/.jaxcache` (listed in .gitignore).  The path is fixed,
never made from a temporary name, a pid or the time, so a later run in
the same checkout finds what an earlier one compiled.

Called by the CLI, bench.py and chip_smoke.py before their first compile.
"""
from __future__ import annotations

import os

ENV = "JAX_COMPILATION_CACHE_DIR"
DEFAULT_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.abspath(__file__))), ".jaxcache")


def enable() -> str:
    """Turn the persistent compile cache on; returns its directory."""
    env = os.environ.get(ENV)
    if env:
        return env
    import jax
    jax.config.update("jax_compilation_cache_dir", DEFAULT_DIR)
    return DEFAULT_DIR
