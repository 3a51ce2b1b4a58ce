"""`findkmer selftest` — the deployment sanity check passes on this
backend, single-device and on the 4-device mesh (subprocess: the real
CLI surface a fresh install would run)."""

import os
import subprocess
import sys

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _run(extra, env_extra=None):
    env = dict(os.environ)
    env["JAX_PLATFORMS"] = "cpu"
    env["PYTHONPATH"] = REPO
    env.update(env_extra or {})
    return subprocess.run(
        [sys.executable, "-m", "findkmer_tpu.cli", "selftest", *extra],
        capture_output=True, text=True, env=env, timeout=300,
    )


@pytest.mark.heavy
def test_selftest_passes_single_device():
    r = _run([])
    assert r.returncode == 0, r.stderr
    assert "selftest OK (3/3 cases bit-exact)" in r.stdout
    assert r.stdout.count("PASS") == 3


@pytest.mark.heavy
def test_selftest_passes_on_mesh():
    r = _run(
        ["--devices", "4"],
        {"XLA_FLAGS": "--xla_force_host_platform_device_count=8"},
    )
    assert r.returncode == 0, r.stderr
    assert "selftest OK (3/3 cases bit-exact)" in r.stdout
