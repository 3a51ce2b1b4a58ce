"""Simulated 2-host `findkmer stream` via CLI: per-host partial spectra
merged with `findkmer merge` equal the single-host spectrum
(BASELINE config 5 shape, simulated hosts — SURVEY.md §4.2)."""

import os
import subprocess
import sys
import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _cli(args, tmp_path):
    env = dict(os.environ)
    env["JAX_PLATFORMS"] = "cpu"
    env["PYTHONPATH"] = REPO
    r = subprocess.run(
        [sys.executable, "-m", "findkmer_tpu.cli"] + args,
        capture_output=True, text=True, env=env, cwd=str(tmp_path),
        timeout=300,
    )
    assert r.returncode == 0, r.stderr
    return r.stdout


@pytest.mark.heavy
def test_two_simulated_hosts_merge(tmp_path, fixtures_dir):
    src = os.path.join(fixtures_dir, "ecoli_frag.fa")
    common = ["-k", "6", "--chunk-len", "1024", "--batch-rows", "4"]

    _cli(["stream", "-i", src, *common, "--num-processes", "2",
          "--process-id", "0", "-o", "h0.tsv"], tmp_path)
    _cli(["stream", "-i", src, *common, "--num-processes", "2",
          "--process-id", "1", "-o", "h1.tsv"], tmp_path)
    merged = _cli(["merge", "-i", "h0.tsv", "h1.tsv"], tmp_path)

    single = _cli(["count", "-i", src, *common], tmp_path)
    assert merged == single


@pytest.mark.heavy
def test_host_resume_composes_with_sharding(tmp_path, fixtures_dir):
    src = os.path.join(fixtures_dir, "ecoli_frag.fa")
    common = ["-k", "5", "--chunk-len", "1024", "--batch-rows", "2"]

    # host 1 of 2 with checkpointing, run twice (second is a full resume)
    a = _cli(["stream", "-i", src, *common, "--num-processes", "2",
              "--process-id", "1", "--checkpoint", "ck",
              "--checkpoint-every", "2"], tmp_path)
    b = _cli(["stream", "-i", src, *common, "--num-processes", "2",
              "--process-id", "1", "--checkpoint", "ck"], tmp_path)
    assert a == b


@pytest.mark.parametrize("k,n_proc", [("6", 2), ("18", 2), ("18", 4)])
@pytest.mark.heavy
def test_coordinator_collective_merge(tmp_path, fixtures_dir, k, n_proc):
    """REAL N-process jax.distributed group on CPU: `stream
    --coordinator` ends in one collective allgather merge — host 0
    writes the FULL spectrum, the others write nothing (round-1 verdict
    item 4; the 4-process case pins the protocol beyond the pairwise
    shape — BASELINE config 5 says N >= 2 hosts)."""
    import socket

    src = os.path.join(fixtures_dir, "ecoli_frag.fa")
    # free port for the coordinator
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    coord = f"127.0.0.1:{port}"
    common = ["stream", "-i", src, "-k", k, "--chunk-len", "1024",
              "--batch-rows", "4", "--coordinator", coord,
              "--num-processes", str(n_proc)]

    env = dict(os.environ)
    env["JAX_PLATFORMS"] = "cpu"
    env["PYTHONPATH"] = REPO
    env.pop("XLA_FLAGS", None)  # one CPU device per process
    procs = [
        subprocess.Popen(
            [sys.executable, "-m", "findkmer_tpu.cli", *common,
             "--process-id", str(i), "-o", f"h{i}.tsv"],
            env=env, cwd=str(tmp_path),
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
        )
        for i in range(n_proc)
    ]
    outs = [p.communicate(timeout=300) for p in procs]
    for p, (_, err) in zip(procs, outs):
        assert p.returncode == 0, err

    # host 0 wrote the FULL spectrum; the others wrote nothing
    full = _cli(["count", "-i", src, "-k", k, "--chunk-len", "1024",
                 "--batch-rows", "4"], tmp_path)
    h0 = (tmp_path / "h0.tsv").read_text()
    assert h0 == full
    for i in range(1, n_proc):
        assert not (tmp_path / f"h{i}.tsv").exists()


@pytest.mark.parametrize("k", ["6", "17"])
@pytest.mark.heavy
def test_coordinator_group_with_device_meshes(tmp_path, fixtures_dir, k):
    """The FULL deployment shape (BASELINE config 5 on a real pod):
    N=2 processes x 4 local devices each, under a real jax.distributed
    group — each host runs a DistributedCounter over its LOCAL 4-device
    mesh (make_counter must not grab other hosts' non-addressable
    chips) and the per-host partials merge collectively.  k=6 = psum
    mesh per host; k=17 = dp_sparse per host."""
    import socket

    src = os.path.join(fixtures_dir, "ecoli_frag.fa")
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    common = ["stream", "-i", src, "-k", k, "--chunk-len", "512",
              "--batch-rows", "4", "--devices", "4",
              "--coordinator", f"127.0.0.1:{port}",
              "--num-processes", "2"]

    env = dict(os.environ)
    env["JAX_PLATFORMS"] = "cpu"
    env["PYTHONPATH"] = REPO
    env["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
    procs = [
        subprocess.Popen(
            [sys.executable, "-m", "findkmer_tpu.cli", *common,
             "--process-id", str(i), "-o", f"h{i}.tsv"],
            env=env, cwd=str(tmp_path),
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
        )
        for i in range(2)
    ]
    outs = [p.communicate(timeout=300) for p in procs]
    for p, (_, err) in zip(procs, outs):
        assert p.returncode == 0, err

    full = _cli(["count", "-i", src, "-k", k, "--chunk-len", "512",
                 "--batch-rows", "4"], tmp_path)
    assert (tmp_path / "h0.tsv").read_text() == full
    assert not (tmp_path / "h1.tsv").exists()


@pytest.mark.heavy
def test_coordinator_group_kill_and_resume(tmp_path, fixtures_dir):
    """Whole-group fault injection (round-4 verdict item 1/missing #3):
    SIGKILL BOTH processes of a live 2-process jax.distributed stream
    once each has checkpointed, then relaunch the group (fresh
    coordinator) with the same --checkpoint; the resumed collective
    merge must be bit-identical to an uninterrupted single-host count.
    Checkpoints land in per-process subdirs of the shared dir
    (streaming._stream_state)."""
    import signal
    import socket
    import time

    src = os.path.join(fixtures_dir, "ecoli_frag.fa")
    env = dict(os.environ)
    env["JAX_PLATFORMS"] = "cpu"
    env["PYTHONPATH"] = REPO
    env.pop("XLA_FLAGS", None)  # one CPU device per process
    ck = tmp_path / "ck"

    def free_port():
        s = socket.socket()
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
        s.close()
        return port

    def launch(port):
        common = ["stream", "-i", src, "-k", "6", "--chunk-len", "512",
                  "--batch-rows", "2", "--coordinator",
                  f"127.0.0.1:{port}", "--num-processes", "2",
                  "--checkpoint", str(ck), "--checkpoint-every", "1"]
        return [
            subprocess.Popen(
                [sys.executable, "-m", "findkmer_tpu.cli", *common,
                 "--process-id", str(i), "-o", f"h{i}.tsv"],
                env=env, cwd=str(tmp_path),
                stdout=subprocess.DEVNULL, stderr=subprocess.DEVNULL,
            )
            for i in range(2)
        ]

    procs = launch(free_port())
    marks = [ck / f"proc{i:03d}" / "latest.json" for i in range(2)]
    deadline = time.time() + 240
    try:
        while time.time() < deadline:
            if all(m.exists() for m in marks):
                break
            if all(p.poll() is not None for p in procs):
                break
            time.sleep(0.05)
        for p in procs:
            if p.poll() is None:
                p.send_signal(signal.SIGKILL)
        for p in procs:
            p.wait(timeout=30)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()

    killed = any(p.returncode == -signal.SIGKILL for p in procs)
    if not killed and not all(m.exists() for m in marks):
        pytest.skip("group finished before both hosts checkpointed")

    # resume the whole group under a fresh coordinator
    procs = launch(free_port())
    for p in procs:
        assert p.wait(timeout=300) == 0

    full = _cli(["count", "-i", src, "-k", "6", "--chunk-len", "512",
                 "--batch-rows", "2"], tmp_path)
    assert (tmp_path / "h0.tsv").read_text() == full
    assert not (tmp_path / "h1.tsv").exists()


@pytest.mark.heavy
def test_stream_sparse_singlehost_resume_oracle(tmp_path, fixtures_dir):
    """Sparse (k=17) single-host stream — the streamed finalize write —
    is oracle-exact, resumes bit-identically from a checkpoint (the
    restored-store -> finalize_chunks combination), and the
    FINDKMER_ORDERED_FINALIZE=0 escape hatch produces the same bytes
    through the legacy heap-merge finalize."""
    from oracle.scalar import count_fasta_file, spectrum_lines

    src = os.path.join(fixtures_dir, "multi.fa")
    common = ["-k", "17", "--chunk-len", "256", "--batch-rows", "2"]
    want = "\n".join(
        spectrum_lines(count_fasta_file(src, 17), 17)
    ) + "\n"

    out = _cli(["stream", "-i", src, *common], tmp_path)
    assert out == want

    # interrupted run: checkpoint every batch, then resume to the end
    _cli(["stream", "-i", src, *common, "--checkpoint", "ck",
          "--checkpoint-every", "1", "-o", "full.tsv"], tmp_path)
    resumed = _cli(["stream", "-i", src, *common, "--checkpoint", "ck"],
                   tmp_path)
    assert resumed == want
    assert (tmp_path / "full.tsv").read_text() == want

    env = dict(os.environ)
    env["JAX_PLATFORMS"] = "cpu"
    env["PYTHONPATH"] = REPO
    env["FINDKMER_ORDERED_FINALIZE"] = "0"
    r = subprocess.run(
        [sys.executable, "-m", "findkmer_tpu.cli", "stream", "-i", src,
         *common],
        capture_output=True, text=True, env=env, cwd=str(tmp_path),
        timeout=300,
    )
    assert r.returncode == 0, r.stderr
    assert r.stdout == want
