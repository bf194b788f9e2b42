"""The persistent compilation cache helper (utils/cache.py)."""

import jax

from optik_tpu.utils import cache


def _capture(monkeypatch):
    calls = {}
    monkeypatch.setattr(jax.config, "update",
                        lambda k, v: calls.__setitem__(k, v))
    return calls


def test_env_dir_is_honoured(monkeypatch, tmp_path):
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path))
    calls = _capture(monkeypatch)
    assert cache.enable_compile_cache() == str(tmp_path)
    assert calls == {}  # sets nothing: JAX reads the variable itself


def test_default_is_fixed_checkout_path(monkeypatch):
    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    calls = _capture(monkeypatch)
    got = cache.enable_compile_cache(min_compile_secs=3.0)
    assert got == str(cache.CACHE_DIR)
    assert cache.CACHE_DIR.name == ".jax_cache"
    assert (cache.CACHE_DIR.parent / "optik_tpu").is_dir()
    assert calls == {"jax_compilation_cache_dir": got,
                     "jax_persistent_cache_min_compile_time_secs": 3.0}
    # The same path on every call: no temporary names, pids or times.
    assert cache.enable_compile_cache(min_compile_secs=3.0) == got
