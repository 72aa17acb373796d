"""Where JAX keeps its persistent compilation cache.

Compiling the device pipelines takes seconds to minutes; the persistent
cache lets a later process reuse what an earlier one compiled.  JAX keys
cache entries by path among other things, so the directory must not move
between runs: it is ``$JAX_COMPILATION_CACHE_DIR`` when that is set, and
``.jax_cache`` at the root of this checkout otherwise.  No other path is
set anywhere in the code.
"""

from __future__ import annotations

import os

CHECKOUT = os.path.dirname(
    os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
)


def cache_dir() -> str:
    """The cache directory this process should use."""
    return os.environ.get("JAX_COMPILATION_CACHE_DIR") or os.path.join(
        CHECKOUT, ".jax_cache"
    )


def enable() -> str:
    """Point JAX's persistent compilation cache at :func:`cache_dir`.

    Call before the first compilation: JAX fixes its cache when it first
    compiles.  Returns the directory.
    """
    import jax

    path = cache_dir()
    jax.config.update("jax_compilation_cache_dir", path)
    return path
