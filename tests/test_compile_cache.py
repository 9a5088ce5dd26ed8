"""The persistent compilation cache's location (p3achygo_tpu/compile_cache.py)."""
import os

import jax
import pytest

from p3achygo_tpu import compile_cache


@pytest.fixture
def restore_config():
    saved = (jax.config.jax_compilation_cache_dir,
             jax.config.jax_persistent_cache_min_compile_time_secs)
    yield
    jax.config.update("jax_compilation_cache_dir", saved[0])
    jax.config.update("jax_persistent_cache_min_compile_time_secs", saved[1])


def test_env_var_set_sets_no_directory(monkeypatch, restore_config, tmp_path):
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path))
    jax.config.update("jax_compilation_cache_dir", "/unchanged")
    assert compile_cache.enable() == str(tmp_path)
    assert jax.config.jax_compilation_cache_dir == "/unchanged"


@pytest.mark.parametrize("dirname", [".jax_cache", ".jax_cache_cpu"])
def test_env_var_unset_uses_fixed_repo_path(monkeypatch, restore_config,
                                            tmp_path, dirname):
    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    monkeypatch.chdir(tmp_path)  # the working directory does not matter
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    path = compile_cache.enable(dirname)
    assert path == os.path.join(repo, dirname)
    assert jax.config.jax_compilation_cache_dir == path
