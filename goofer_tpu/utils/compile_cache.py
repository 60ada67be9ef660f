"""Where compiled graphs persist between processes.

JAX reads ``JAX_COMPILATION_CACHE_DIR`` itself; when the environment sets
it, the program sets no directory.  Otherwise the XLA cache lives at a
fixed path inside the checkout, ``<repo>/.cache/xla`` (listed in
``.gitignore``).  The path is part of what a later process must find
again, so it is never built from a temp name, a PID or the time.
"""
from __future__ import annotations

import os
from pathlib import Path

CACHE_ROOT = Path(__file__).resolve().parents[2] / ".cache"

# graphs that compile faster than this are not worth a disk round trip
_MIN_COMPILE_SECS = 0.3


def xla_cache_dir(environ=os.environ) -> str | None:
    """The cache directory the program sets, or None when the
    environment already names one."""
    if environ.get("JAX_COMPILATION_CACHE_DIR"):
        return None
    return str(CACHE_ROOT / "xla")


def setup_compile_cache() -> None:
    """Point JAX's persistent compilation cache at its directory."""
    import jax

    cache_dir = xla_cache_dir()
    if cache_dir is not None:
        os.makedirs(cache_dir, exist_ok=True)
        jax.config.update("jax_compilation_cache_dir", cache_dir)
    jax.config.update("jax_persistent_cache_min_compile_time_secs",
                      _MIN_COMPILE_SECS)
