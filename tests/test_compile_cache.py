"""Where the persistent compilation cache goes (utils/compile_cache.py)."""

from pathlib import Path

import jax
import pytest

from ldpc_sparc_tpu.utils.compile_cache import enable_persistent_cache


@pytest.fixture
def restore_cache_config():
    old = (jax.config.jax_compilation_cache_dir,
           jax.config.jax_persistent_cache_min_compile_time_secs)
    yield
    jax.config.update("jax_compilation_cache_dir", old[0])
    jax.config.update("jax_persistent_cache_min_compile_time_secs", old[1])


def test_env_var_wins(monkeypatch, tmp_path, restore_cache_config):
    """With JAX_COMPILATION_CACHE_DIR set, no directory is set in code:
    JAX's own reading of the variable stands."""
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path))
    before = jax.config.jax_compilation_cache_dir
    assert enable_persistent_cache() == str(tmp_path)
    assert jax.config.jax_compilation_cache_dir == before


def test_default_is_fixed_repo_path(monkeypatch, restore_cache_config):
    """Without the variable the cache is <repo>/.jax_cache/<backend>, the
    same path on every call."""
    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    repo = Path(__file__).resolve().parent.parent
    want = str(repo / ".jax_cache" / jax.default_backend())
    assert enable_persistent_cache() == want
    assert enable_persistent_cache() == want
    assert jax.config.jax_compilation_cache_dir == want
