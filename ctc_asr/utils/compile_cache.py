"""Where JAX keeps its persistent compilation cache.

If ``JAX_COMPILATION_CACHE_DIR`` is set, JAX reads it itself and
nothing here overrides it. Otherwise the cache lives at one fixed path
inside the checkout, ``<repo>/.jax_cache`` (listed in ``.gitignore``),
so a later run in the same checkout finds what this one compiled. Entry
points (``cli.main``, ``bench.py``, ``chip_smoke.py``)
call ``setup_compile_cache`` before they compile anything.
"""

from __future__ import annotations

import os

REPO_CACHE_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__)))), ".jax_cache")


def setup_compile_cache() -> str:
    """Point JAX's persistent compile cache at its directory; returns
    the directory in use."""
    env = os.environ.get("JAX_COMPILATION_CACHE_DIR")
    if env:
        return env
    import jax
    jax.config.update("jax_compilation_cache_dir", REPO_CACHE_DIR)
    return REPO_CACHE_DIR
