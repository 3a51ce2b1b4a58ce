"""Token fixed-seed fuzz sweeps, pytest-collected (round-4 verdict
item 4): ~20 trials of each manual harness run on every suite pass, so
a regression in the randomized config space (k x geometry x mode x
noise, mesh width x merge) is caught without anyone remembering to run
the big sweeps.  The hundreds-of-trials sweeps stay manual
(tests/fuzz_oracle.py, tests/fuzz_dist.py — see CLAUDE.md)."""

import os
import subprocess
import sys

HERE = os.path.dirname(os.path.abspath(__file__))
REPO = os.path.dirname(HERE)


def _run_harness(script, seed, n):
    env = dict(os.environ)
    env["JAX_PLATFORMS"] = "cpu"
    env["PYTHONPATH"] = REPO
    r = subprocess.run(
        [sys.executable, os.path.join(HERE, script), str(seed), str(n)],
        capture_output=True, text=True, env=env, timeout=560,
    )
    assert r.returncode == 0, (r.stdout[-2000:], r.stderr[-2000:])
    assert f"done: {n} trials, 0 failures" in r.stdout, r.stdout[-3000:]


def test_fuzz_oracle_token_sweep():
    _run_harness("fuzz_oracle.py", seed=205, n=20)


def test_fuzz_dist_token_sweep():
    _run_harness("fuzz_dist.py", seed=205, n=20)
