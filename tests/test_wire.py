"""Ordered-finalize wire v2: every code-leg x count-leg combination is
byte-exact vs the oracle (see ops/sparse.py "wire v2").

The legs are DATA-gated (byte-plane codes when the top-24 run table is
small; count plane when exceptions would outweigh it), so these tests
construct inputs that force each mode and then assert the mode actually
engaged (via the plan the pull returns) — a silent gate regression
can't pass as "still exact through the other leg".
"""

import io

import numpy as np
import pytest

from conftest import random_dna
from findkmer_tpu import pipeline
from findkmer_tpu.config import Config
from findkmer_tpu.io.fasta import FastaReader
from findkmer_tpu.models.counter import KmerCounter

from test_vs_oracle import check, count_text, oracle_dict, spectrum_to_dict


def _plan_of(text, cfg):
    """Run the pipeline, return (plan, spectrum_dict) via the ordered
    pull (the production finalize path)."""
    import contextlib

    counter = KmerCounter(cfg)
    state = counter.init_state()
    reader = FastaReader(io.BytesIO(text.encode()))
    for rows in pipeline.batches_from_codes(
        pipeline.code_stream(reader), cfg
    ):
        state = counter.step(state, rows)
    state = counter.compact(state)
    state, _ = counter._ensure_capacity(state)
    nullph = lambda name: contextlib.nullcontext()  # noqa: E731
    plan = counter._ordered_pull(state.store, nullph)
    spectrum = counter._finalize_ordered(state.store)
    return plan, spectrum_to_dict(spectrum, cfg.k)


@pytest.mark.parametrize("k", [6, 11, 13, 15])
def test_bytes3_narrow_exact_and_engaged(rng, k):
    """Narrow codes: the byte-plane leg engages (top-24 runs are few
    for k <= 15) and the spectrum is oracle-exact."""
    text = f">r\n{random_dna(rng, 4000, n_prob=0.01)}\n"
    cfg = Config(k=k, chunk_len=256, batch_rows=2, table_mode="sparse")
    plan, got = _plan_of(text, cfg)
    assert len(plan.code_chunks[0]) == 3 and plan.run_shift == 24
    assert got == oracle_dict(text, k)


def test_bytes3_wide_exact_and_engaged(rng):
    """Wide codes (k=17): >5.5K distinct makes 8*n_runs < N, so the
    byte-plane leg carries ALL bits >= 24 in the run table."""
    text = f">r\n{random_dna(rng, 9000)}\n"
    cfg = Config(k=17, chunk_len=512, batch_rows=2, table_mode="sparse")
    plan, got = _plan_of(text, cfg)
    assert len(plan.code_chunks[0]) == 3 and plan.run_shift == 24
    assert got == oracle_dict(text, 17)


def test_lo_hi_runs_fallback_exact(rng):
    """Wide codes with FEW distinct (small N): the top-24 run table
    would not pay, so the round-4 leg (lo + hi runs, shift 32) holds."""
    text = f">r\n{random_dna(rng, 800)}\n"
    cfg = Config(k=17, chunk_len=256, batch_rows=2, table_mode="sparse")
    plan, got = _plan_of(text, cfg)
    assert len(plan.code_chunks[0]) == 1 and plan.run_shift == 32
    assert got == oracle_dict(text, 17)


def test_count_plane_engages_on_repeat_heavy(rng):
    """Every k-mer appearing 3x makes n_multi == distinct > N/8: the
    count plane replaces per-entry exceptions; spectrum exact."""
    seq = random_dna(rng, 3000)
    text = "".join(f">r{i}\n{seq}\n" for i in range(3))
    cfg = Config(k=17, chunk_len=512, batch_rows=2, table_mode="sparse")
    plan, got = _plan_of(text, cfg)
    assert plan.cnt_chunks is not None
    assert plan.exc_idx.size == 0  # no count exceeds 255
    assert got == oracle_dict(text, 17)


def test_count_plane_escapes_over_255(rng):
    """A k-mer with count > 255 rides the escape overlay on the count
    plane (position-keyed, so 255-valued plane slots stay unambiguous).
    Poly-A repeated makes A^k count ~2800 and every other k-mer 8x."""
    seq = random_dna(rng, 350) + "A" * 2800 + random_dna(rng, 350)
    text = "".join(f">r{i}\n{seq}\n" for i in range(8))
    cfg = Config(k=13, chunk_len=512, batch_rows=2, table_mode="sparse")
    plan, got = _plan_of(text, cfg)
    assert plan.cnt_chunks is not None
    assert plan.exc_idx.size >= 1  # the poly-A escape
    assert int(max(plan.exc_cnt)) > 255
    assert got == oracle_dict(text, 13)


def test_exception_leg_still_exact(rng):
    """Mostly-singleton store keeps the round-4 exception leg (plane
    off) — the chr-scale profile."""
    text = f">r\n{random_dna(rng, 20000)}\n"
    cfg = Config(k=21, chunk_len=1024, batch_rows=2, table_mode="sparse")
    plan, got = _plan_of(text, cfg)
    assert plan.cnt_chunks is None
    assert got == oracle_dict(text, 21)


@pytest.mark.parametrize("chunks", [1, 3, 7])
def test_multi_chunk_reassembly_all_modes(rng, monkeypatch, chunks):
    """Forced chunk counts stress span reassembly for BOTH new legs
    (byte planes + count plane) and the streamed finalize_chunks."""
    monkeypatch.setenv("FINDKMER_FINALIZE_CHUNKS", str(chunks))
    seq = random_dna(rng, 2500, n_prob=0.02)
    text = "".join(f">r{i}\n{seq}\n" for i in range(3))
    cfg = Config(k=17, chunk_len=256, batch_rows=2, table_mode="sparse")
    check(text, cfg)
    # streamed variant concatenates to the same spectrum
    counter = KmerCounter(cfg)
    state = counter.init_state()
    reader = FastaReader(io.BytesIO(text.encode()))
    for rows in pipeline.batches_from_codes(
        pipeline.code_stream(reader), cfg
    ):
        state = counter.step(state, rows)
    parts = list(counter.finalize_chunks(state))
    codes = np.concatenate([c for c, _ in parts])
    counts = np.concatenate([n for _, n in parts])
    assert spectrum_to_dict((codes, counts), cfg.k) == oracle_dict(
        text, cfg.k
    )


def _count_dist(text, cfg, n_dev):
    from findkmer_tpu.parallel.dist import DistributedCounter
    from findkmer_tpu.parallel.mesh import make_mesh

    dc = DistributedCounter(cfg, make_mesh(n_dev))
    state = dc.init_state()
    reader = FastaReader(io.BytesIO(text.encode()))
    for rows in pipeline.batches_from_codes(
        pipeline.code_stream(reader), cfg
    ):
        state = dc.step(state, rows)
    return dc.finalize(state), dc


def test_mesh_count_plane_repeat_heavy(rng):
    """dp_sparse per-row wire: a repeat-heavy mesh store takes the
    count-plane leg (N < 8*E) and stays oracle-exact — including a
    >255 escape from a poly-A run repeated across records.  The leg
    choice is asserted so a gate regression can't pass silently
    through the (equally exact) exception leg."""
    seq = random_dna(rng, 1200) + "A" * 400 + random_dna(rng, 400)
    text = "".join(f">r{i}\n{seq}\n" for i in range(10))
    cfg = Config(k=17, devices=4, chunk_len=256, batch_rows=4,
                 table_mode="sparse")
    spectrum, dc = _count_dist(text, cfg, 4)
    got = spectrum_to_dict(spectrum, 17)
    want = oracle_dict(text, 17)
    assert got == want
    assert dc._wire_cnt_plane  # count-plane leg engaged
    assert max(want.values()) > 255  # the poly-A escape engaged


def test_mesh_exception_leg_still_exact(rng):
    """Mostly-singleton mesh store big enough that the padded (G, E)
    exception tables undercut the count plane (N >= 8*E at the E=256
    ladder floor: per-row live prefix >= 2048) keeps the exception leg;
    exact.  Small singleton stores correctly pick the PLANE — the
    256-slot exception floor makes it the cheaper wire there."""
    text = f">r\n{random_dna(rng, 200000)}\n"
    cfg = Config(k=21, devices=4, chunk_len=512, batch_rows=4,
                 table_mode="sparse")
    spectrum, dc = _count_dist(text, cfg, 4)
    assert spectrum_to_dict(spectrum, 21) == oracle_dict(text, 21)
    assert not dc._wire_cnt_plane  # exception leg held


def test_wide_k27_per_entry_hi(rng):
    """k > 26 with few distinct: neither run leg pays — per-entry
    (hi, lo) planes remain exact."""
    text = f">r\n{random_dna(rng, 600)}\n"
    cfg = Config(k=27, chunk_len=256, batch_rows=2, table_mode="sparse")
    plan, got = _plan_of(text, cfg)
    assert got == oracle_dict(text, 27)


@pytest.mark.parametrize("k", [29, 31])
def test_bytes3_refused_past_k28(rng, k):
    """Regression (round-5 fuzz seed 77): at k >= 29 the composite top
    word (2k-24 bits) no longer fits uint32, so the byte-plane leg
    must be REFUSED even when the run table is tiny (few distinct
    codes) — engaging it wrapped (hi << 8) and corrupted codes."""
    text = f">r\n{random_dna(rng, 150)}\n"  # few distinct: tiny run table
    cfg = Config(k=k, chunk_len=128, batch_rows=2, table_mode="sparse")
    plan, got = _plan_of(text, cfg)
    assert len(plan.code_chunks[0]) != 3  # byte planes refused
    assert got == oracle_dict(text, k)


def test_bytes3_wide_boundary_k28(rng):
    """k=28 is the last k whose top word fits uint32: the byte-plane
    leg engages on a tiny-run-table store and stays exact."""
    text = f">r\n{random_dna(rng, 150)}\n"
    cfg = Config(k=28, chunk_len=128, batch_rows=2, table_mode="sparse")
    plan, got = _plan_of(text, cfg)
    assert len(plan.code_chunks[0]) == 3 and plan.run_shift == 24
    assert got == oracle_dict(text, 28)
