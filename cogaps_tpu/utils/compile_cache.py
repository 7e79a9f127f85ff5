"""Where JAX keeps its persistent compilation cache.

Compiling the sampler's phase programs takes seconds to minutes, and a
fresh process pays it again unless compiled programs persist on disk.
The cache directory is part of every entry's lookup, so it must be a
fixed path: a directory that moves between runs never hits.

* ``JAX_COMPILATION_CACHE_DIR`` set: JAX reads it itself; nothing here
  overrides it.
* otherwise: ``<checkout>/.jax_cache`` (listed in ``.gitignore``), unless
  the caller already set ``jax_compilation_cache_dir`` in code.
"""

from __future__ import annotations

import os

ENV_VAR = "JAX_COMPILATION_CACHE_DIR"
DEFAULT_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__)))), ".jax_cache")


def configure_compile_cache() -> str:
    """Place the persistent compilation cache; returns the directory in
    use. Idempotent; call before the first compilation so it takes
    effect for every program."""
    import jax

    if os.environ.get(ENV_VAR):
        return os.environ[ENV_VAR]
    if not jax.config.jax_compilation_cache_dir:
        jax.config.update("jax_compilation_cache_dir", DEFAULT_DIR)
    return jax.config.jax_compilation_cache_dir
