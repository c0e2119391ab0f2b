"""The persistent compile cache helper (hevc_tpu/compile_cache.py)."""
import os

import jax
import pytest

from hevc_tpu import compile_cache


@pytest.fixture
def restore_cache_dir():
    old = jax.config.jax_compilation_cache_dir
    yield
    jax.config.update("jax_compilation_cache_dir", old)


def test_env_var_is_left_to_jax(monkeypatch, restore_cache_dir, tmp_path):
    monkeypatch.setenv(compile_cache.ENV, str(tmp_path))
    jax.config.update("jax_compilation_cache_dir", None)
    assert compile_cache.enable() == str(tmp_path)
    # nothing set in code: JAX reads the variable itself
    assert jax.config.jax_compilation_cache_dir is None


def test_default_is_one_fixed_path_in_the_checkout(monkeypatch,
                                                    restore_cache_dir):
    monkeypatch.delenv(compile_cache.ENV, raising=False)
    got = compile_cache.enable()
    assert got == compile_cache.enable()          # stable across calls
    assert jax.config.jax_compilation_cache_dir == got
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    assert got == os.path.join(root, ".jaxcache")
