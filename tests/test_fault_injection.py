"""Fault injection: SIGKILL a streaming run mid-flight, resume from its
checkpoint, and require a bit-identical spectrum (SURVEY.md §5 failure
detection / BASELINE config 5 overlap handling under restart)."""

import os
import signal
import subprocess
import sys
import time

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _env():
    env = dict(os.environ)
    env["JAX_PLATFORMS"] = "cpu"
    env["PYTHONPATH"] = REPO
    return env


def _cli(args, tmp_path, timeout=300):
    r = subprocess.run(
        [sys.executable, "-m", "findkmer_tpu.cli"] + args,
        capture_output=True, text=True, env=_env(), cwd=str(tmp_path),
        timeout=timeout,
    )
    assert r.returncode == 0, r.stderr
    return r.stdout


@pytest.mark.heavy
def test_sigkill_mid_stream_resume_bit_identical(tmp_path, fixtures_dir):
    src = os.path.join(fixtures_dir, "ecoli_frag.fa")
    common = ["-k", "6", "--chunk-len", "512", "--batch-rows", "2"]
    ck = tmp_path / "ck"

    # start a streaming run that checkpoints every batch, and SIGKILL it
    # as soon as the first checkpoint lands
    proc = subprocess.Popen(
        [sys.executable, "-m", "findkmer_tpu.cli", "stream", "-i", src,
         *common, "--checkpoint", str(ck), "--checkpoint-every", "1",
         "-o", str(tmp_path / "never.tsv")],
        env=_env(), cwd=str(tmp_path),
        stdout=subprocess.DEVNULL, stderr=subprocess.DEVNULL,
    )
    deadline = time.time() + 240
    try:
        while time.time() < deadline:
            if (ck / "latest.json").exists():
                break
            if proc.poll() is not None:
                break  # finished before we could kill it — still a test
            time.sleep(0.05)
        if proc.poll() is None:
            proc.send_signal(signal.SIGKILL)
            proc.wait(timeout=30)
    finally:
        if proc.poll() is None:
            proc.kill()

    killed_mid_run = proc.returncode == -signal.SIGKILL
    if not killed_mid_run and not (ck / "latest.json").exists():
        pytest.skip("run finished before any checkpoint was written")

    # resume to completion and compare against a fresh full count
    resumed = _cli(
        ["stream", "-i", src, *common, "--checkpoint", str(ck)], tmp_path
    )
    full = _cli(["count", "-i", src, *common], tmp_path)
    assert resumed == full


@pytest.mark.heavy
def test_sigkill_mid_stream_mesh_resume_bit_identical(
    tmp_path, fixtures_dir
):
    """--checkpoint composed with --devices 4 (round-4 verdict item 1):
    SIGKILL a 4-device dp_sparse mesh stream once its first checkpoint
    lands; resume must produce the bit-identical spectrum.  A real pod
    host always has multiple local devices, so this is the deployment
    shape of BASELINE configs 3/5."""
    src = os.path.join(fixtures_dir, "ecoli_frag.fa")
    common = ["-k", "17", "--devices", "4", "--chunk-len", "512",
              "--batch-rows", "4", "--sparse-compact-entries", "8192"]
    ck = tmp_path / "ck"

    env = _env()
    flags = env.get("XLA_FLAGS", "")
    if "xla_force_host_platform_device_count" not in flags:
        env["XLA_FLAGS"] = (
            flags + " --xla_force_host_platform_device_count=8"
        ).strip()

    proc = subprocess.Popen(
        [sys.executable, "-m", "findkmer_tpu.cli", "stream", "-i", src,
         *common, "--checkpoint", str(ck), "--checkpoint-every", "1",
         "-o", str(tmp_path / "never.tsv")],
        env=env, cwd=str(tmp_path),
        stdout=subprocess.DEVNULL, stderr=subprocess.DEVNULL,
    )
    deadline = time.time() + 240
    try:
        while time.time() < deadline:
            if (ck / "latest.json").exists():
                break
            if proc.poll() is not None:
                break
            time.sleep(0.05)
        if proc.poll() is None:
            proc.send_signal(signal.SIGKILL)
            proc.wait(timeout=30)
    finally:
        if proc.poll() is None:
            proc.kill()

    if proc.returncode != -signal.SIGKILL and not (
        (ck / "latest.json").exists()
    ):
        pytest.skip("run finished before any checkpoint was written")

    r = subprocess.run(
        [sys.executable, "-m", "findkmer_tpu.cli", "stream", "-i", src,
         *common, "--checkpoint", str(ck)],
        capture_output=True, text=True, env=env, cwd=str(tmp_path),
        timeout=300,
    )
    assert r.returncode == 0, r.stderr
    full = _cli(["count", "-i", src, *common], tmp_path)
    assert r.stdout == full


@pytest.mark.heavy
def test_sigkill_mid_spill_resume_bit_identical(tmp_path, fixtures_dir):
    """--spill composed with --checkpoint (VERDICT round-2 item 4): kill
    a spilling, checkpointing stream once both a checkpoint AND at least
    one spill run exist; resume must produce the bit-identical spectrum
    (runs spilled after the adopted checkpoint are discarded and their
    batches replayed)."""
    src = os.path.join(fixtures_dir, "ecoli_frag.fa")
    common = ["-k", "16", "--chunk-len", "512", "--batch-rows", "2",
              "--sparse-capacity", "2048",
              "--sparse-compact-entries", "4096"]
    ck = tmp_path / "ck"
    sp = tmp_path / "sp"

    proc = subprocess.Popen(
        [sys.executable, "-m", "findkmer_tpu.cli", "stream", "-i", src,
         *common, "--spill", str(sp), "--checkpoint", str(ck),
         "--checkpoint-every", "2", "-o", str(tmp_path / "never.tsv")],
        env=_env(), cwd=str(tmp_path),
        stdout=subprocess.DEVNULL, stderr=subprocess.DEVNULL,
    )
    deadline = time.time() + 240

    def spilled():
        return sp.exists() and any(
            p.name.endswith(".codes.npy") for p in sp.iterdir()
        )

    try:
        while time.time() < deadline:
            if (ck / "latest.json").exists() and spilled():
                break
            if proc.poll() is not None:
                break
            time.sleep(0.05)
        if proc.poll() is None:
            proc.send_signal(signal.SIGKILL)
            proc.wait(timeout=30)
    finally:
        if proc.poll() is None:
            proc.kill()

    if proc.returncode != -signal.SIGKILL and not (
        (ck / "latest.json").exists()
    ):
        pytest.skip("run finished before any checkpoint was written")

    resumed = _cli(
        ["stream", "-i", src, *common, "--spill", str(sp),
         "--checkpoint", str(ck)], tmp_path
    )
    # reference: a plain full count (capacity knobs never change output)
    full = _cli(["count", "-i", src, "-k", "16", "--chunk-len", "512",
                 "--batch-rows", "2"], tmp_path)
    assert resumed == full
