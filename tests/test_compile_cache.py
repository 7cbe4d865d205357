"""Where the persistent compilation cache goes: JAX_COMPILATION_CACHE_DIR
wins and nothing is set in code; otherwise the checkout's .jax_cache; an
explicit directory (the CLI's --compile-cache-dir) overrides both."""

import os

import pytest

from sgvamp.utils import compile_cache as cc


@pytest.mark.parametrize("env,explicit,want", [
    ("/somewhere/jax", None, None),
    (None, None, os.path.join(cc.CHECKOUT, ".jax_cache")),
    (None, "/tmp/explicit_cache", "/tmp/explicit_cache"),
    ("/somewhere/jax", "/tmp/explicit_cache", "/tmp/explicit_cache"),
    (None, "", None),
])
def test_resolve_cache_dir(monkeypatch, env, explicit, want):
    if env is None:
        monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    else:
        monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", env)
    assert cc.resolve_cache_dir(explicit) == want


def test_checkout_is_repo_root():
    assert os.path.exists(os.path.join(cc.CHECKOUT, "sgvamp", "__init__.py"))


def test_env_set_means_no_config_update(monkeypatch):
    import jax

    calls = []
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", "/somewhere/jax")
    monkeypatch.setattr(jax.config, "update", lambda *a: calls.append(a))
    assert cc.enable_compile_cache() is None
    assert calls == []
