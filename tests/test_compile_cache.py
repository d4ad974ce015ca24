"""The persistent compilation cache lives where JAX_COMPILATION_CACHE_DIR
says, or else at one fixed path inside the checkout."""
import os

import jax
import pytest

from bpt_tpu import compile_cache

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture
def restore_config():
    old = jax.config.jax_compilation_cache_dir
    yield
    jax.config.update("jax_compilation_cache_dir", old)


def test_env_set_is_left_to_jax(monkeypatch, tmp_path, restore_config):
    monkeypatch.setenv(compile_cache.ENV, str(tmp_path / "cache"))
    before = jax.config.jax_compilation_cache_dir
    assert compile_cache.enable_compile_cache() == str(tmp_path / "cache")
    assert jax.config.jax_compilation_cache_dir == before


def test_env_unset_uses_checkout_dir(monkeypatch, tmp_path,
                                     restore_config):
    monkeypatch.delenv(compile_cache.ENV, raising=False)
    want = os.path.join(REPO, ".jax_cache")
    seen = []
    for cwd in (REPO, str(tmp_path)):
        monkeypatch.chdir(cwd)
        seen.append(compile_cache.enable_compile_cache())
        assert jax.config.jax_compilation_cache_dir == want
    assert seen == [want, want]
