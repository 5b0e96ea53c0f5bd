"""Where JAX's persistent compilation cache lives.

One rule for every entry point (scripts and the test suite): when
``JAX_COMPILATION_CACHE_DIR`` is set, that directory is the cache and no
other is set; otherwise the caller's fixed default directory is.  A cache
path is part of the cache's key, so it is never built from a temporary name,
a process id or the time — a directory that moves never hits.
"""
from __future__ import annotations

import os

import jax

ENV_VAR = "JAX_COMPILATION_CACHE_DIR"


def use_compile_cache(default_dir: str) -> str:
    """Point JAX's persistent compilation cache at ``$JAX_COMPILATION_CACHE_DIR``
    if set, else at ``default_dir``.  Call before the first compilation.
    Returns the directory in use."""
    path = os.environ.get(ENV_VAR) or os.path.abspath(default_dir)
    jax.config.update("jax_compilation_cache_dir", path)
    return path
