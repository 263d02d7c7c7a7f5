"""JAX's persistent compilation cache, at one fixed place.

A cold meta step compiles the 90-step inner scan around the unrolled LSTM
under `vmap` and `grad`, which takes a large share of a short run. The
persistent cache keeps compiled programs across processes. Its directory is
part of the cache key, so it must not move between runs: never a temporary,
pid- or time-named path.
"""

from __future__ import annotations

import os

REPO_CACHE_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))),
    ".jax_cache",
)


def enable_compile_cache() -> str:
    """Return the cache directory, setting it if the environment does not.

    `JAX_COMPILATION_CACHE_DIR`, when set, is JAX's own setting and is left
    alone. Otherwise the cache goes to `<repo>/.jax_cache`.
    """
    env = os.environ.get("JAX_COMPILATION_CACHE_DIR")
    if env:
        return env
    import jax

    jax.config.update("jax_compilation_cache_dir", REPO_CACHE_DIR)
    return REPO_CACHE_DIR
