"""Where compiled programs persist between processes.

JAX's persistent compilation cache keys each entry on the cache path
among other things, so the path must not move between runs: it is the
directory ``JAX_COMPILATION_CACHE_DIR`` names when that is set, and the
checkout's own ``.jax_cache/`` (listed in .gitignore) otherwise.
"""

from __future__ import annotations

import os

__all__ = ["cache_dir", "enable"]

_CHECKOUT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))


def cache_dir() -> str:
    """The compile-cache directory this program uses."""
    return (os.environ.get("JAX_COMPILATION_CACHE_DIR")
            or os.path.join(_CHECKOUT, ".jax_cache"))


def enable() -> str:
    """Point JAX's persistent compilation cache at :func:`cache_dir` and
    return the path.  Call before the first compilation."""
    import jax

    path = cache_dir()
    jax.config.update("jax_compilation_cache_dir", path)
    return path
