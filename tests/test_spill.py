"""Disk-spill counting (findkmer_tpu/spill.py): HBM-bounded sparse
stores with sorted run files + streaming k-way finalize merge."""

import os
import subprocess
import sys

import numpy as np
import pytest

from conftest import random_dna
from findkmer_tpu import spill
from findkmer_tpu.config import Config
from test_vs_oracle import count_text, oracle_dict, spectrum_to_dict

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


# ---------------------------------------------------------------- unit

def _dict_merge(runs):
    d = {}
    for c, n in runs:
        for ci, ni in zip(c.tolist(), n.tolist()):
            d[ci] = d.get(ci, 0) + ni
    return d


@pytest.mark.parametrize("native_merge", [True, False])
@pytest.mark.parametrize("block", [7, 64, 1 << 20])
def test_iter_merged_matches_dict(rng, block, native_merge, monkeypatch):
    """Block merge == dict merge for overlapping runs at adversarial
    block sizes (bound straddles duplicates across runs); both the C
    heap-merge and the numpy-fallback block merges."""
    if not native_merge:
        from findkmer_tpu.io import native

        monkeypatch.setattr(native, "available", lambda: False)
    runs = []
    for _ in range(5):
        codes = np.unique(
            rng.integers(0, 500, size=rng.integers(0, 400)).astype(
                np.uint64
            )
        )
        counts = rng.integers(1, 100, size=codes.size).astype(np.int64)
        runs.append((codes, counts))
    got_c, got_n = [], []
    for c, n in spill.iter_merged(runs, block=block):
        assert np.all(np.diff(c.astype(np.int64)) > 0)  # sorted distinct
        got_c.append(c)
        got_n.append(n)
    got = dict(
        zip(
            np.concatenate(got_c).tolist() if got_c else [],
            np.concatenate(got_n).tolist() if got_n else [],
        )
    )
    assert got == _dict_merge(runs)
    # chunk boundaries are globally ordered too
    allc = np.concatenate(got_c) if got_c else np.empty(0, np.uint64)
    assert np.all(np.diff(allc.astype(np.int64)) > 0)


def test_iter_merged_empty_runs():
    assert list(spill.iter_merged([])) == []
    e = np.empty(0, np.uint64)
    assert list(spill.iter_merged([(e, e.astype(np.int64))])) == []


def test_run_roundtrip(tmp_path, rng):
    codes = np.unique(rng.integers(0, 1 << 40, size=100).astype(np.uint64))
    counts = rng.integers(1, 9, size=codes.size).astype(np.int64)
    spill.write_run(str(tmp_path), 0, codes, counts)
    (run,) = spill.load_runs(str(tmp_path))
    np.testing.assert_array_equal(np.asarray(run[0]), codes)
    np.testing.assert_array_equal(np.asarray(run[1]), counts)


# ------------------------------------------------------------- engine

def _count_text_spill(text, cfg):
    """count_text that also returns the counter (to inspect spills)."""
    import io as _io

    from findkmer_tpu import pipeline
    from findkmer_tpu.io.fasta import FastaReader
    from findkmer_tpu.models.counter import KmerCounter

    counter = KmerCounter(cfg)
    state = counter.init_state()
    for rows in pipeline.batches_from_codes(
        pipeline.code_stream(FastaReader(_io.BytesIO(text.encode()))), cfg
    ):
        state = counter.step(state, rows)
    return counter.finalize(state), counter


@pytest.mark.parametrize("k", [12, 21])
def test_spill_count_matches_oracle(tmp_path, rng, k):
    """Tiny sparse_capacity forces multiple spills; the spectrum stays
    bit-exact vs the oracle, and consumed run files are deleted."""
    seq = random_dna(rng, 12000, n_prob=0.02)
    text = ">r\n" + seq + "\n"
    cfg = Config(
        k=k, chunk_len=64, batch_rows=8, table_mode="sparse",
        sparse_capacity=512, sparse_compact_entries=1024,
        spill_dir=str(tmp_path / "sp"),
    )
    spectrum, counter = _count_text_spill(text, cfg)
    assert counter._spill_n >= 2
    assert spill.load_runs(cfg.spill_dir) == []  # consumed + removed
    assert spectrum_to_dict(spectrum, k) == oracle_dict(text, k)
    # a second finalize of spilled state is a clean error, and reusing
    # the counter for a new state is too
    with pytest.raises(RuntimeError, match="spill runs missing"):
        next(iter(counter._merged_spill_chunks(None, None)))
    with pytest.raises(RuntimeError, match="fresh counter"):
        counter.init_state()


def test_spill_canonical_matches_oracle(tmp_path, rng):
    seq = random_dna(rng, 8000, n_prob=0.02)
    text = ">r\n" + seq + "\n"
    cfg = Config(
        k=21, canonical=True, chunk_len=64, batch_rows=8,
        table_mode="sparse", sparse_capacity=512,
        sparse_compact_entries=1024, spill_dir=str(tmp_path / "sp"),
    )
    spectrum, counter = _count_text_spill(text, cfg)
    assert counter._spill_n >= 1
    assert spectrum_to_dict(spectrum, 21) == oracle_dict(
        text, 21, canonical=True
    )


def test_spill_requires_sparse(tmp_path):
    from findkmer_tpu.models.counter import KmerCounter

    with pytest.raises(ValueError, match="sparse"):
        KmerCounter(Config(k=4, spill_dir=str(tmp_path / "sp")))


def test_spill_rejects_dirty_dir(tmp_path, rng):
    """A FRESH count (init_state) refuses a spill dir holding another
    count's runs; checkpoint resume adopts them instead
    (adopt_spill_runs)."""
    from findkmer_tpu.models.counter import KmerCounter

    d = str(tmp_path / "sp")
    codes = np.array([1, 2], np.uint64)
    spill.write_run(d, 0, codes, np.array([1, 1], np.int64))
    with pytest.raises(ValueError, match="already contains"):
        KmerCounter(Config(k=21, spill_dir=d)).init_state()


@pytest.mark.parametrize("k", [12, 21])
def test_spill_dist_matches_oracle(tmp_path, rng, k):
    """Per-device disk spill on the 8-device mesh: tiny capacity forces
    spills of every device store; spectrum stays exact and one run per
    device lands per spill."""
    import io as _io

    from findkmer_tpu import pipeline
    from findkmer_tpu.io.fasta import FastaReader
    from findkmer_tpu.parallel import DistributedCounter, make_mesh

    seq = random_dna(rng, 48000, n_prob=0.02)
    text = ">r\n" + seq + "\n"
    cfg = Config(
        k=k, chunk_len=64, batch_rows=8, table_mode="sparse",
        sparse_capacity=128, sparse_compact_entries=2048,
        spill_dir=str(tmp_path / "sp"),
    )
    dc = DistributedCounter(cfg, make_mesh(8))
    state = dc.init_state()
    for rows in pipeline.batches_from_codes(
        pipeline.code_stream(FastaReader(_io.BytesIO(text.encode()))), cfg
    ):
        state = dc.step(state, rows)
    spectrum = dc.finalize(state)
    assert dc._spill_n >= 8  # at least one full spill of all devices
    assert spectrum_to_dict(spectrum, k) == oracle_dict(text, k)


def test_spill_rejects_dense_dist(tmp_path):
    from findkmer_tpu.models.counter import make_counter

    with pytest.raises(ValueError, match="sparse"):
        make_counter(Config(k=8, devices=8, spill_dir=str(tmp_path / "x")))


def test_spill_checkpoint_composes(tmp_path, rng):
    """table_state after a spill: snapshot the RESIDUAL store, adopt
    the spilled runs on restore, finalize bit-exact (VERDICT round-2
    item 4 — the old fence error is gone)."""
    from findkmer_tpu.models.counter import KmerCounter

    cfg = Config(
        k=21, chunk_len=64, batch_rows=8, table_mode="sparse",
        sparse_capacity=512, sparse_compact_entries=1024,
        spill_dir=str(tmp_path / "sp"),
    )
    import io as _io

    from findkmer_tpu import pipeline
    from findkmer_tpu.io.fasta import FastaReader

    text = ">r\n" + random_dna(rng, 12000) + "\n"
    counter = KmerCounter(cfg)
    state = counter.init_state()
    for rows in pipeline.batches_from_codes(
        pipeline.code_stream(FastaReader(_io.BytesIO(text.encode()))), cfg
    ):
        state = counter.step(state, rows)
    state = counter.compact(state)
    state = counter.compact(counter.step(state, rows))  # spill trigger
    if counter._spill_n == 0:
        pytest.skip("capacity not crossed in this geometry")
    n_runs = counter._spill_n
    state, table = counter.table_state(state)  # must not raise anymore
    # restore into a fresh counter adopting the on-disk runs
    c2 = KmerCounter(cfg)
    st2 = c2.restore_state(table)
    c2.adopt_spill_runs(n_runs, token=spill.read_token(cfg.spill_dir))
    got = c2.finalize(st2)
    # reference: same stream, no spill/checkpoint
    c3 = KmerCounter(cfg.replace(spill_dir="", sparse_capacity=1 << 22))
    st3 = c3.init_state()
    for rows in pipeline.batches_from_codes(
        pipeline.code_stream(FastaReader(_io.BytesIO(text.encode()))), cfg
    ):
        st3 = c3.step(st3, rows)
    st3 = c3.step(st3, rows)  # the extra batch the spill path counted
    want = c3.finalize(st3)
    assert (got[0] == want[0]).all() and (got[1] == want[1]).all()


# ---------------------------------------------------------------- CLI

def _cli(args, tmp_path):
    env = dict(os.environ)
    env["JAX_PLATFORMS"] = "cpu"
    env["PYTHONPATH"] = REPO
    return subprocess.run(
        [sys.executable, "-m", "findkmer_tpu.cli"] + args,
        capture_output=True, text=True, env=env, cwd=str(tmp_path),
        timeout=300,
    )


@pytest.mark.heavy
def test_spill_cli_byte_identical(tmp_path, fixtures_dir):
    """count --spill with a tiny capacity == plain count, byte-for-byte
    (the ecoli fragment has ~30k distinct 21-mers, forcing many runs)."""
    src = os.path.join(fixtures_dir, "ecoli_frag.fa")
    base = ["count", "-i", src, "-k", "21", "--table-mode", "sparse",
            "--chunk-len", "1024", "--batch-rows", "8",
            "--sparse-compact-entries", "8192"]
    r0 = _cli(base + ["-o", "plain.tsv"], tmp_path)
    assert r0.returncode == 0, r0.stderr
    r1 = _cli(
        base + ["-o", "spilled.tsv", "--spill", "sp",
                "--sparse-capacity", "4096"],
        tmp_path,
    )
    assert r1.returncode == 0, r1.stderr
    assert (tmp_path / "plain.tsv").read_bytes() == (
        tmp_path / "spilled.tsv"
    ).read_bytes()
    # consumed run files are removed after the successful finalize
    assert spill.load_runs(str(tmp_path / "sp")) == []


@pytest.mark.heavy
def test_spill_two_simulated_hosts(tmp_path, fixtures_dir):
    """stream --num-processes 2 --spill: per-process subdirs; merged
    per-host partials equal the plain single count."""
    src = os.path.join(fixtures_dir, "ecoli_frag.fa")
    common = ["-k", "18", "--chunk-len", "1024", "--batch-rows", "8",
              "--sparse-capacity", "512",
              "--sparse-compact-entries", "2048"]
    for pid, out in (("0", "h0.tsv"), ("1", "h1.tsv")):
        r = _cli(["stream", "-i", src, *common, "--num-processes", "2",
                  "--process-id", pid, "--spill", "sp", "-o", out],
                 tmp_path)
        assert r.returncode == 0, r.stderr
        assert (tmp_path / "sp" / f"proc{int(pid):03d}").is_dir()
    rm = _cli(["merge", "-i", "h0.tsv", "h1.tsv"], tmp_path)
    assert rm.returncode == 0, rm.stderr
    rc = _cli(["count", "-i", src, "-k", "18", "--chunk-len", "1024",
               "--batch-rows", "8"], tmp_path)
    assert rm.stdout == rc.stdout


@pytest.mark.heavy
def test_spill_cli_stream_checkpoint_composes(tmp_path, fixtures_dir):
    """stream --spill --checkpoint runs to completion and matches a
    plain count byte-for-byte (the round-2 fence error is gone)."""
    src = os.path.join(fixtures_dir, "ecoli_frag.fa")
    r = _cli(
        ["stream", "-i", src, "-k", "21", "--spill", "sp",
         "--checkpoint", "ck", "--checkpoint-every", "4",
         "--sparse-capacity", "4096",
         "--sparse-compact-entries", "8192",
         "--chunk-len", "1024", "--batch-rows", "4", "-o", "s.tsv"],
        tmp_path,
    )
    assert r.returncode == 0, r.stderr
    r2 = _cli(["count", "-i", src, "-k", "21", "--chunk-len", "1024",
               "--batch-rows", "4", "-o", "c.tsv"], tmp_path)
    assert r2.returncode == 0, r2.stderr
    assert (tmp_path / "s.tsv").read_bytes() == \
        (tmp_path / "c.tsv").read_bytes()


def test_adopt_spill_runs_truncates_and_validates(tmp_path):
    """Resume-time run adoption: runs past the checkpoint manifest are
    deleted (their batches replay); a truncated dir is unrecoverable."""
    import numpy as np

    from findkmer_tpu import spill
    from findkmer_tpu.config import Config
    from findkmer_tpu.models.counter import KmerCounter

    sp = tmp_path / "sp"
    for i in range(3):
        spill.write_run(str(sp), i,
                        np.array([i + 1], np.uint64),
                        np.array([1], np.int64))
    tok = spill.write_token(str(sp))
    cfg = Config(k=21, spill_dir=str(sp))
    c = KmerCounter(cfg)
    c.adopt_spill_runs(2, token=tok)
    assert c._spill_n == 2
    assert len(spill.load_runs(str(sp))) == 2  # run 2 deleted
    c2 = KmerCounter(cfg)
    with pytest.raises(RuntimeError, match="expects 5 spill runs"):
        c2.adopt_spill_runs(5, token=tok)
    # spill off but manifest promises runs -> clear error
    c3 = KmerCounter(Config(k=21))
    with pytest.raises(ValueError, match="--spill is off"):
        c3.adopt_spill_runs(1)


def test_adopt_spill_runs_refuses_foreign_runs(tmp_path):
    """Runs stamped by a DIFFERENT stream are never adopted OR deleted:
    a checkpoint that recorded 0 runs must not wipe another count's
    crash state out of a shared dir (round-3 review finding)."""
    import numpy as np

    from findkmer_tpu import spill
    from findkmer_tpu.config import Config
    from findkmer_tpu.models.counter import KmerCounter

    sp = tmp_path / "sp"
    spill.write_run(str(sp), 0,
                    np.array([7], np.uint64), np.array([3], np.int64))
    spill.write_token(str(sp))  # the other stream's identity
    cfg = Config(k=21, spill_dir=str(sp))
    # manifest says 0 runs, foreign token -> refuse (and keep the files)
    with pytest.raises(RuntimeError, match="different stream"):
        KmerCounter(cfg).adopt_spill_runs(0, token="someone-else")
    assert len(spill.load_runs(str(sp))) == 1  # nothing deleted
    # old manifests carry no token: with runs present, still refuse
    with pytest.raises(RuntimeError, match="different stream"):
        KmerCounter(cfg).adopt_spill_runs(1, token=None)
    # empty dir + no token is a clean no-op resume and re-stamps
    sp2 = tmp_path / "sp2"
    sp2.mkdir()
    c = KmerCounter(Config(k=21, spill_dir=str(sp2)))
    c.adopt_spill_runs(0, token="restamped")
    assert spill.read_token(str(sp2)) == "restamped"
    # pre-token legacy state (no token on either side) resumes when
    # the run count matches the manifest EXACTLY (round-3 review:
    # old checkpoints must not be stranded by the new guard)
    sp3 = tmp_path / "sp3"
    spill.write_run(str(sp3), 0,
                    np.array([9], np.uint64), np.array([2], np.int64))
    c = KmerCounter(Config(k=21, spill_dir=str(sp3)))
    c.adopt_spill_runs(1, token=None)
    assert c._spill_n == 1
    assert len(spill.load_runs(str(sp3))) == 1  # adopted, not deleted


def test_stream_count_api_multiproc_spill_subdirs(tmp_path, rng):
    """The PUBLIC stream_count API gives multi-host runs per-process
    spill subdirs (round-5 review finding: the remap lived only in the
    CLI adapter, so API callers sharing a filesystem collided on the
    spill identity token)."""
    from conftest import random_dna
    from findkmer_tpu import pipeline, streaming
    from findkmer_tpu.config import Config
    from findkmer_tpu.ops.sparse import merge_host_runs

    seq = random_dna(rng, 4000)
    src = tmp_path / "in.fa"
    src.write_text(f">r\n{seq}\n")
    spd = tmp_path / "sp"
    cfg = Config(k=17, chunk_len=256, batch_rows=2,
                 sparse_compact_entries=1024, sparse_capacity=64,
                 spill_dir=str(spd))
    parts = [
        streaming.stream_count([str(src)], cfg, num_processes=2,
                               process_id=i)
        for i in range(2)
    ]
    assert (spd / "proc000").exists() and (spd / "proc001").exists()
    merged = merge_host_runs([p for p in parts if p[0].size])
    plain = pipeline.count_file(
        str(src), Config(k=17, chunk_len=256, batch_rows=2)
    )
    np.testing.assert_array_equal(merged[0], plain[0])
    np.testing.assert_array_equal(merged[1], plain[1])


def test_init_dir_detects_noncontiguous_stale_runs(tmp_path):
    """A crash midway through remove_runs (deletes from 0 up) leaves a
    non-contiguous tail; init_dir must refuse it, not let load_runs'
    contiguous walk miss it and merge another count's runs in
    (round-5 review)."""
    d = str(tmp_path / "sp")
    for i in (5, 6):  # stale tail, no run00000
        spill.write_run(d, i, np.array([i], np.uint64),
                        np.array([1], np.int64))
    assert spill.load_runs(d) == []  # the contiguous walk misses them
    with pytest.raises(ValueError, match="already contains run files"):
        spill.init_dir(d)
    # remove_runs now globs: clears the stale tail too
    spill.remove_runs(d)
    spill.init_dir(d)  # accepted once actually empty
