"""Persistent XLA compile cache -- the FFTW-wisdom analog.

The reference amortizes FFTW planning cost across runs with wisdom
files (fastcard/fastcard.c:32-37,139-144; rpi/fastdet.cfg:12).  The
equivalent here is JAX's persistent compilation cache: compiled
executables for the batched detect program are stored on disk, so a
cold `thrifty-tpu detect`/`serve` start skips XLA compilation entirely
when the program was compiled before.

Enabled by every CLI entry point (thrifty_tpu.cli), bench.py and
chip_smoke.py.  The location is ``$JAX_COMPILATION_CACHE_DIR`` when
set (no other directory is set in code), else the fixed
``<checkout>/.jax_cache`` -- a path that does not depend on the working
directory, the process or the time, since the path is part of what
makes a later run find the cache.
"""

from __future__ import annotations

import os

ENV_VAR = "JAX_COMPILATION_CACHE_DIR"

DEFAULT_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
    ".jax_cache")


def enable_compile_cache():
    """Point JAX's persistent compilation cache at its directory.

    Returns the cache directory in use.
    """
    import jax

    # JAX reads the variable when it is imported; applying it again
    # here covers a variable set later in the same process.
    cache_dir = os.environ.get(ENV_VAR) or DEFAULT_DIR
    jax.config.update("jax_compilation_cache_dir", cache_dir)
    # Cache every program, however small or fast to compile: the CLIs
    # compile a handful of programs and cold-start latency is what is
    # being amortized.
    jax.config.update("jax_persistent_cache_min_entry_size_bytes", -1)
    jax.config.update("jax_persistent_cache_min_compile_time_secs", 0)
    return cache_dir
