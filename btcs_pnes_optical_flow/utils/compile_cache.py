"""Location of JAX's persistent compilation cache."""

from __future__ import annotations

import os

import jax

# Fixed path inside the checkout, so that every later run finds what an
# earlier one compiled (listed in .gitignore).
DEFAULT_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))),
    ".jax_cache",
)


def enable_compile_cache() -> str:
    """Turn on the persistent compilation cache; return its directory.

    ``JAX_COMPILATION_CACHE_DIR`` names the directory when it is set;
    otherwise the cache lives at :data:`DEFAULT_DIR`.
    """
    path = os.environ.get("JAX_COMPILATION_CACHE_DIR") or DEFAULT_DIR
    jax.config.update("jax_compilation_cache_dir", path)
    jax.config.update("jax_persistent_cache_min_compile_time_secs", 0.5)
    jax.config.update("jax_persistent_cache_min_entry_size_bytes", 0)
    return path
