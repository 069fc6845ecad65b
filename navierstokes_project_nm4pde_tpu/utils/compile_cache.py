"""Where JAX keeps its persistent compilation cache.

One rule for every entry point (the CLI, bench.py, chip_smoke.py): when
JAX_COMPILATION_CACHE_DIR is set, JAX reads it itself and nothing is set
here; otherwise the cache lives in `.jax_cache/` at the repository root.
The path is fixed -- no pid, time or temporary directory in it -- so a
second run of the same program finds what the first one compiled.
"""

from __future__ import annotations

import os

ENV_VAR = "JAX_COMPILATION_CACHE_DIR"
REPO_CACHE_DIR = os.path.join(
    os.path.dirname(
        os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    ),
    ".jax_cache",
)


def compile_cache_dir() -> str:
    """The directory the persistent compilation cache uses."""
    return os.environ.get(ENV_VAR) or REPO_CACHE_DIR


def enable_compile_cache() -> str:
    """Apply the rule above; returns the cache directory in use."""
    if os.environ.get(ENV_VAR):
        return os.environ[ENV_VAR]
    import jax

    jax.config.update("jax_compilation_cache_dir", REPO_CACHE_DIR)
    return REPO_CACHE_DIR
