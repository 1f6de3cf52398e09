"""Entry-point runtime rules (utils/runtime.py): where the compile cache
lives, and that no entry point falls back to the CPU unless asked."""

import os

import jax
import pytest

from decentralized_ekf_mhe_tpu.utils import runtime


def _record_updates(monkeypatch):
    calls = []
    monkeypatch.setattr(jax.config, "update",
                        lambda name, value: calls.append((name, value)))
    return calls


def test_cache_dir_from_environment_sets_nothing(monkeypatch, tmp_path):
    calls = _record_updates(monkeypatch)
    env = {runtime.CACHE_ENV: str(tmp_path / "cache")}
    assert runtime.compile_cache_dir(env) == str(tmp_path / "cache")
    assert runtime.enable_compile_cache(env) == str(tmp_path / "cache")
    assert calls == []          # JAX reads the variable itself


def test_cache_dir_default_is_fixed_inside_the_checkout(monkeypatch):
    calls = _record_updates(monkeypatch)
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    expected = os.path.join(repo, ".jax_cache")
    for env in ({}, {runtime.CACHE_ENV: ""}):
        assert runtime.compile_cache_dir(env) == expected
        assert runtime.enable_compile_cache(env) == expected
    assert calls == [("jax_compilation_cache_dir", expected)] * 2
    # the path is part of the cache key: the same on every call
    assert runtime.compile_cache_dir({}) == runtime.compile_cache_dir({})


def test_init_backend_refuses_cpu_unless_asked(monkeypatch):
    _record_updates(monkeypatch)
    with pytest.raises(SystemExit, match="no GPU found"):
        runtime.init_backend()
    assert runtime.init_backend(cpu=True)[0].platform == "cpu"
