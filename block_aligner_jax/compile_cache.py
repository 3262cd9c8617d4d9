"""JAX's persistent compilation cache for the repository's launchers.

``chip_smoke.py``, ``bench.py`` and ``examples/run_results.py`` call
``enable()`` once at start-up; nothing else sets a cache.
"""

from __future__ import annotations

import os
from pathlib import Path

#: default cache location: ``<checkout>/.jax_cache`` (git-ignored)
DEFAULT_DIR = Path(__file__).resolve().parent.parent / ".jax_cache"


def enable() -> str:
    """Keep compiled executables in ``JAX_COMPILATION_CACHE_DIR`` when it is
    set, else in ``<checkout>/.jax_cache``; returns the directory."""
    import jax

    path = os.environ.get("JAX_COMPILATION_CACHE_DIR") or str(DEFAULT_DIR)
    jax.config.update("jax_compilation_cache_dir", path)
    return path
