"""The persistent compilation cache: JAX_COMPILATION_CACHE_DIR when set,
else one fixed path in the checkout."""

import os
import subprocess
import sys

import pytest

from findkmer_tpu.utils import compile_cache

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _record_updates(monkeypatch):
    import jax

    calls = []
    monkeypatch.setattr(jax.config, "update",
                        lambda name, value: calls.append((name, value)))
    return calls


def test_env_dir_wins(monkeypatch, tmp_path):
    calls = _record_updates(monkeypatch)
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path))
    assert compile_cache.enable_compile_cache() == str(tmp_path)
    assert calls == []  # JAX reads the variable itself


def test_fixed_checkout_path(monkeypatch):
    calls = _record_updates(monkeypatch)
    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    got = compile_cache.enable_compile_cache()
    assert got == os.path.join(REPO, ".cache", "jax")
    assert ("jax_compilation_cache_dir", got) in calls
    assert compile_cache.enable_compile_cache() == got  # never moves


@pytest.mark.heavy
def test_cli_writes_cache_to_env_dir(tmp_path, fixtures_dir):
    """A `findkmer count` run puts its cache entries in
    JAX_COMPILATION_CACHE_DIR (test_env_dir_wins: no other directory is
    set in code)."""
    cache = tmp_path / "cache"
    env = dict(os.environ, JAX_PLATFORMS="cpu", PYTHONPATH=REPO,
               JAX_COMPILATION_CACHE_DIR=str(cache),
               JAX_PERSISTENT_CACHE_MIN_COMPILE_TIME_SECS="0")
    r = subprocess.run(
        [sys.executable, "-m", "findkmer_tpu.cli", "count", "-i",
         os.path.join(fixtures_dir, "tiny.fa"), "-k", "4",
         "-o", str(tmp_path / "out.tsv")],
        capture_output=True, text=True, env=env, timeout=300,
    )
    assert r.returncode == 0, r.stderr
    assert any(cache.iterdir())
