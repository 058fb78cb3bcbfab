"""Persistent XLA compilation cache location, shared by every entry point.

Compiling a chain at a real geometry takes tens of seconds, and every
entry point (the apps' ``main()``, ``bench.py``, ``bench_scaling.py``,
``chip_smoke.py``, ``tools/``) compiles the same steps.  They all call
``enable_compile_cache()`` so that one cache serves them:

  - ``JAX_COMPILATION_CACHE_DIR`` set: JAX reads it itself; nothing is
    changed here.
  - otherwise: ``<checkout>/.jax_cache`` (gitignored).  The path is fixed
    because it is part of the cache key — a directory that moves never hits.
"""

from __future__ import annotations

import os

ENV_VAR = "JAX_COMPILATION_CACHE_DIR"
DEFAULT_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__)))), ".jax_cache")


def enable_compile_cache() -> str:
    """Point JAX's persistent compilation cache at the shared directory
    (see module docstring) and return the directory in use."""
    if os.environ.get(ENV_VAR):
        return os.environ[ENV_VAR]
    import jax
    jax.config.update("jax_compilation_cache_dir", DEFAULT_DIR)
    return DEFAULT_DIR
