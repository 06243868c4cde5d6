"""Persistent compilation cache location for the program's entry points.

JAX reads ``JAX_COMPILATION_CACHE_DIR`` itself; when it is set the program
uses that directory and sets no other.  Otherwise the cache goes to
``<checkout>/.jax_cache`` (git-ignored): a fixed path, because the path is
part of the cache key, so a directory that moves never hits.

Entry points (the CLI, ``bench.py`` children, ``__graft_entry__.py``,
``chip_smoke.py``) call :func:`enable_compile_cache`; importing the package
does not, so library users and the test suite keep JAX's defaults.
"""

from __future__ import annotations

import os

_ENV = "JAX_COMPILATION_CACHE_DIR"
_CHECKOUT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def compile_cache_dir() -> str:
    """The cache directory in effect for an entry point."""
    return os.environ.get(_ENV) or os.path.join(_CHECKOUT, ".jax_cache")


def enable_compile_cache() -> str:
    """Point JAX's persistent cache at :func:`compile_cache_dir`; returns it."""
    path = compile_cache_dir()
    if not os.environ.get(_ENV):
        import jax

        jax.config.update("jax_compilation_cache_dir", path)
    return path
