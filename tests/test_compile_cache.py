"""The one compile-cache helper (benchmarks/compile_cache.py):
$JAX_COMPILATION_CACHE_DIR when set and no other directory, else the fixed
<checkout>/.jax_cache."""

import os

import jax
import pytest

from benchmarks import compile_cache

CHECKOUT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def test_env_var_wins(monkeypatch, tmp_path):
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path))
    assert compile_cache.compile_cache_dir() == str(tmp_path)


@pytest.mark.parametrize("value", [None, ""])
def test_default_is_checkout_cache(monkeypatch, value):
    if value is None:
        monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    else:
        monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", value)
    assert compile_cache.compile_cache_dir() == os.path.join(
        CHECKOUT, ".jax_cache")


def test_enable_points_jax_at_the_directory(monkeypatch, tmp_path):
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path))
    old = (jax.config.jax_compilation_cache_dir,
           jax.config.jax_persistent_cache_min_entry_size_bytes,
           jax.config.jax_persistent_cache_min_compile_time_secs)
    try:
        assert compile_cache.enable_compile_cache() == str(tmp_path)
        assert jax.config.jax_compilation_cache_dir == str(tmp_path)
        assert jax.config.jax_persistent_cache_min_compile_time_secs == 0.0
    finally:
        jax.config.update("jax_compilation_cache_dir", old[0])
        jax.config.update("jax_persistent_cache_min_entry_size_bytes",
                          old[1])
        jax.config.update("jax_persistent_cache_min_compile_time_secs",
                          old[2])


def test_cache_dir_is_gitignored():
    with open(os.path.join(CHECKOUT, ".gitignore")) as f:
        assert ".jax_cache/" in f.read().split()
