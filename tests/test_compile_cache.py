"""Placement of JAX's persistent compile cache (utils/compile_cache.py)."""

import pathlib

import jax
import pytest

from ngsf_hmm.utils import compile_cache

REPO = pathlib.Path(__file__).resolve().parents[1]


def test_env_set_leaves_the_directory_to_jax(monkeypatch):
    monkeypatch.setenv(compile_cache.ENV, "/elsewhere/cache")
    assert compile_cache.cache_dir() is None
    before = jax.config.jax_compilation_cache_dir
    assert compile_cache.enable_compile_cache() is None
    assert jax.config.jax_compilation_cache_dir == before


@pytest.mark.parametrize("environ", [{}, {"HOME": "/h", "TMPDIR": "/t"}])
def test_env_unset_uses_the_fixed_checkout_directory(environ):
    d = compile_cache.cache_dir(environ)
    assert d == REPO / ".jax_cache"
    # a fixed path: the same on every call and in every process
    assert d == compile_cache.cache_dir(dict(environ))


def test_checkout_cache_is_ignored_by_git():
    ignored = (REPO / ".gitignore").read_text().split()
    assert ".jax_cache/" in ignored
