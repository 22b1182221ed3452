"""The persistent compile cache: one rule for every entry point."""

import os

import jax
import pytest

from conservation_fem_tpu.utils import compile_cache

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture
def config_updates(monkeypatch):
    """Record jax.config.update calls instead of changing this process's
    configuration."""
    calls = []
    monkeypatch.setattr(jax.config, "update",
                        lambda name, value: calls.append((name, value)))
    return calls


def test_env_var_set_means_no_directory_in_code(monkeypatch, config_updates):
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", "/elsewhere/cache")
    assert compile_cache.enable_compile_cache() == "/elsewhere/cache"
    assert config_updates == []


def test_default_is_the_fixed_checkout_path(monkeypatch, config_updates):
    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    monkeypatch.setattr(os, "makedirs", lambda *a, **k: None)
    used = compile_cache.enable_compile_cache()
    assert used == os.path.join(ROOT, ".jax_cache")
    assert ("jax_compilation_cache_dir", used) in config_updates
    # the same path on every call: no temporary name, pid or time in it
    assert compile_cache.enable_compile_cache() == used


def test_default_directory_is_git_ignored():
    with open(os.path.join(ROOT, ".gitignore")) as f:
        assert ".jax_cache/" in f.read().split()


@pytest.mark.parametrize("entry", ["bench.py", "chip_smoke.py",
                                   "__graft_entry__.py",
                                   "conservation_fem_tpu/__main__.py"])
def test_entry_points_set_the_cache_only_through_the_helper(entry):
    with open(os.path.join(ROOT, entry)) as f:
        src = f.read()
    assert "enable_compile_cache()" in src
    assert "jax_compilation_cache_dir" not in src
