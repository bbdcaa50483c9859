"""Location of JAX's persistent compilation cache, shared by every entry
point (``bench.py``, ``chip_smoke.py``, ``__graft_entry__.py`` and the test
suite).

A cache is found again only where it was written, so the directory must
not change between runs: it is either the one the user names in
``JAX_COMPILATION_CACHE_DIR`` (which JAX reads itself) or the fixed
``<repo>/.jax_cache``, never a temporary or per-process name.
"""

from __future__ import annotations

import os

import jax

__all__ = ["DEFAULT_CACHE_DIR", "configure_compile_cache"]

DEFAULT_CACHE_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))),
    ".jax_cache",
)


def configure_compile_cache() -> str:
    """Point JAX's persistent compilation cache at its directory and return
    that directory.  With ``JAX_COMPILATION_CACHE_DIR`` set, JAX's own
    reading of the variable stands and no other directory is set."""
    jax.config.update("jax_persistent_cache_min_compile_time_secs", 1.0)
    env = os.environ.get("JAX_COMPILATION_CACHE_DIR")
    if env:
        return env
    jax.config.update("jax_compilation_cache_dir", DEFAULT_CACHE_DIR)
    return DEFAULT_CACHE_DIR
