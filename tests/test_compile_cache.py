"""The persistent compile cache: JAX_COMPILATION_CACHE_DIR wins, else the
fixed <repo>/.jax_cache."""

from pathlib import Path

import jax
import pytest

from arkoserenderer.utils import compile_cache


@pytest.fixture()
def restore_config():
    keys = ("jax_compilation_cache_dir", "jax_persistent_cache_min_compile_time_secs")
    saved = {k: getattr(jax.config, k) for k in keys}
    yield
    for k, v in saved.items():
        jax.config.update(k, v)


def test_default_dir_is_fixed_in_the_repo():
    assert Path(compile_cache.DEFAULT_DIR) == Path(__file__).resolve().parents[1] / ".jax_cache"


def test_uses_the_default_dir_without_the_variable(monkeypatch, restore_config):
    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    assert compile_cache.enable_compile_cache() == compile_cache.DEFAULT_DIR
    assert jax.config.jax_compilation_cache_dir == compile_cache.DEFAULT_DIR


def test_honours_jax_compilation_cache_dir(monkeypatch, tmp_path, restore_config):
    jax.config.update("jax_compilation_cache_dir", None)
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path))
    assert compile_cache.enable_compile_cache() == str(tmp_path)
    # The variable is JAX's own setting; the module sets no directory.
    assert jax.config.jax_compilation_cache_dir is None
