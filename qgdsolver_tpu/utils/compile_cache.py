"""Persistent XLA compilation cache for the program's entry points.

A cold run compiles every jitted step; with the cache, a second run of the
same configuration loads the compiled executables instead.  The cache key
includes the directory, so the directory is fixed: an explicit
`JAX_COMPILATION_CACHE_DIR` (which JAX reads itself) or `.jax_cache/` at
the checkout root — never a temporary name, a process id or the time.

`enable()` is called by `cli.main`, `bench.main` and `chip_smoke.main`,
never on import.
"""
from __future__ import annotations

import os

import jax

ENV_VAR = "JAX_COMPILATION_CACHE_DIR"
DEFAULT_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(
        __file__)))), ".jax_cache")


def enable() -> str:
    """Turn the persistent compilation cache on; return its directory.

    With `JAX_COMPILATION_CACHE_DIR` set, JAX already uses that directory
    and nothing is changed here."""
    env = os.environ.get(ENV_VAR)
    if env:
        return env
    jax.config.update("jax_compilation_cache_dir", DEFAULT_DIR)
    return DEFAULT_DIR
