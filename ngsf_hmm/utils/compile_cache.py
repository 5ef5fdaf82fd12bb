"""Where JAX's persistent compilation cache lives.

Compiling the EM step and the chain kernels for the GPU takes tens of
seconds; the cache lets a second process (a rerun, the next phase of a
smoke run) load them instead. JAX reads JAX_COMPILATION_CACHE_DIR
itself, so when that is set the program sets nothing; otherwise the
cache goes to a fixed directory of the checkout. The path is part of
what makes a cache hit, so it is never built from a temp name, a pid or
the time.
"""

import os
import pathlib

ENV = "JAX_COMPILATION_CACHE_DIR"
DEFAULT_DIR = pathlib.Path(__file__).resolve().parents[2] / ".jax_cache"


def cache_dir(environ=None):
    """The directory this program points JAX at, or None when
    JAX_COMPILATION_CACHE_DIR is set (JAX then uses it unaided)."""
    environ = os.environ if environ is None else environ
    return None if ENV in environ else DEFAULT_DIR


def enable_compile_cache():
    """Point JAX's persistent compilation cache at cache_dir(); call
    before the first compile. Returns the directory set, or None."""
    d = cache_dir()
    if d is not None:
        import jax

        jax.config.update("jax_compilation_cache_dir", str(d))
    return d
