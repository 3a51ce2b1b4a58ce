"""Sparse (log-structured sorted store) tests vs a Python dict
(SURVEY.md §7 M5; round-2 architecture in ops/sparse.py)."""

import numpy as np
import pytest
import jax.numpy as jnp

from findkmer_tpu.ops.sparse import (
    SENTINEL,
    compact_counted,
    compact_counted_narrow,
    compact_raw,
    compact_raw_narrow,
    ladder,
    rle_pos,
    rle_val,
    squeeze,
    store_to_host,
)

SENT = np.uint32(0xFFFFFFFF)


def _dict_counts(hi, lo):
    d = {}
    for h, l in zip(np.asarray(hi).ravel(), np.asarray(lo).ravel()):
        if l != SENT:
            key = (int(h) << 32) | int(l)
            d[key] = d.get(key, 0) + 1
    return d


def _store_to_dict(hi, lo, cnt):
    hi, lo, cnt = map(np.asarray, (hi, lo, cnt))
    d = {}
    for h, l, c in zip(hi, lo, cnt):
        if c > 0:
            d[(int(h) << 32) | int(l)] = int(c)
    return d


def test_compact_raw_matches_dict(rng):
    hi = rng.integers(0, 4, 500).astype(np.uint32)
    lo = rng.integers(0, 40, 500).astype(np.uint32)
    invalid = rng.random(500) < 0.2
    hi[invalid] = SENT
    lo[invalid] = SENT
    chi, clo, cnt, distinct = compact_raw(jnp.asarray(hi), jnp.asarray(lo))
    want = _dict_counts(hi, lo)
    assert _store_to_dict(chi, clo, cnt) == want
    assert int(distinct) == len(want)
    # sorted by code (holes keep their code; sentinels last)
    key = (
        np.asarray(chi).astype(object) * (1 << 32)
        + np.asarray(clo).astype(object)
    )
    assert (np.diff(key) >= 0).all()


def test_compact_raw_narrow_matches_dict(rng):
    lo = rng.integers(0, 60, 400).astype(np.uint32)
    lo[rng.random(400) < 0.15] = SENT
    clo, cnt, distinct = compact_raw_narrow(jnp.asarray(lo))
    want = _dict_counts(np.zeros_like(lo), lo)
    assert _store_to_dict(np.zeros_like(np.asarray(clo)), clo, cnt) == want
    assert int(distinct) == len(want)


def test_compact_counted_accumulates(rng):
    """Repeated store-carrying compactions (store + raw-as-cnt-1) match
    a dict accumulated over the same stream."""
    expect = {}
    store = None
    for _ in range(5):
        hi = rng.integers(0, 3, 100).astype(np.uint32)
        lo = rng.integers(0, 25, 100).astype(np.uint32)
        for k_, v in _dict_counts(hi, lo).items():
            expect[k_] = expect.get(k_, 0) + v
        if store is None:
            store = compact_raw(jnp.asarray(hi), jnp.asarray(lo))[:3]
        else:
            chi = jnp.concatenate([store[0], jnp.asarray(hi)])
            clo = jnp.concatenate([store[1], jnp.asarray(lo)])
            ccnt = jnp.concatenate(
                [store[2], jnp.ones((100,), jnp.int32)]
            )
            store = compact_counted(chi, clo, ccnt)[:3]
    assert _store_to_dict(*store) == expect
    # squeeze pushes holes out; live prefix = sorted distinct
    shi, slo, scnt = squeeze(*store)
    codes, counts = store_to_host(shi, slo, scnt)
    assert {int(c): int(n) for c, n in zip(codes, counts)} == expect
    assert (np.diff(codes.astype(object)) > 0).all()


def test_rle_pos_and_val_match_dict(rng):
    lo = np.sort(rng.integers(0, 50, 300).astype(np.uint32))
    hi = np.zeros(300, np.uint32)
    cnt = rle_pos(jnp.asarray(hi), jnp.asarray(lo))
    got = {}
    for code, c in zip(lo, np.asarray(cnt)):
        if c:
            got[int(code)] = got.get(int(code), 0) + int(c)
    want = {}
    for code in lo:
        want[int(code)] = want.get(int(code), 0) + 1
    assert got == want

    cvals = rng.integers(1, 9, 300).astype(np.int32)
    cnt2 = rle_val(jnp.asarray(hi), jnp.asarray(lo), jnp.asarray(cvals))
    got2 = {}
    for code, c in zip(lo, np.asarray(cnt2)):
        if c:
            got2[int(code)] = got2.get(int(code), 0) + int(c)
    want2 = {}
    for code, c in zip(lo, cvals):
        want2[int(code)] = want2.get(int(code), 0) + int(c)
    assert got2 == want2


def test_rle_val_exact_past_2e31_observations():
    """Regression (round-2 advisor finding): run totals stay exact when
    cumulative observations exceed 2^31 — value-propagating cummax
    wrapped negative and corrupted later runs."""
    lo = jnp.asarray(np.array([1, 2, 3, 3], np.uint32))
    hi = jnp.zeros((4,), jnp.uint32)
    cnt = jnp.asarray(
        np.array([1_600_000_000, 1_600_000_000, 5, 1], np.int32)
    )
    out = rle_val(hi, lo, cnt)
    d = _store_to_dict(np.zeros(4, np.uint32), lo, out)
    assert d[3] == 6
    assert d[1] == 1_600_000_000
    assert d[2] == 1_600_000_000


def test_rle_val_exact_past_2e32_observations():
    """Cumulative observations past 2^32 (a full u32 cumsum wrap BETWEEN
    runs): every per-run total still fits the dtype and must stay exact.
    Locks the wrap-safety contract of the segmented affine scan (round-4
    gather-free rle_val)."""
    lo = jnp.asarray(np.array([1, 2, 3, 4, 4, 5], np.uint32))
    hi = jnp.zeros((6,), jnp.uint32)
    cnt = jnp.asarray(np.array(
        [2_000_000_000, 2_000_000_000, 2_000_000_000, 5, 1, 7], np.int32
    ))  # cumsum crosses 2^32 inside run 3->4
    out = rle_val(hi, lo, cnt)
    d = _store_to_dict(np.zeros(6, np.uint32), lo, out)
    assert d == {1: 2_000_000_000, 2: 2_000_000_000,
                 3: 2_000_000_000, 4: 6, 5: 7}


def test_capacity_error_single_chip(rng):
    import pytest
    from conftest import random_dna
    from findkmer_tpu import api

    seq = random_dna(rng, 2000)
    with pytest.raises(RuntimeError, match="sparse_capacity"):
        api.count_text(">r\n" + seq + "\n", 21, chunk_len=64,
                       batch_rows=2, sparse_capacity=16)


def test_ladder():
    assert ladder(1, floor=1024) == 1024
    assert ladder(1025, floor=1024) == 1536
    assert ladder(1537, floor=1024) == 2048
    assert ladder(5000, floor=1024) == 6144
    assert ladder(1 << 23, floor=1024) == 1 << 23


def test_log_store_repeated_compactions_match_oracle(rng):
    """A tiny compaction threshold forces many store-carrying
    compactions (sort3 + value-RLE + squeeze); spectrum stays exact."""
    from conftest import random_dna
    from findkmer_tpu.config import Config
    from test_vs_oracle import check

    seq = random_dna(rng, 4000, n_prob=0.03)
    cfg = Config(
        k=17, chunk_len=64, batch_rows=2, sparse_capacity=16384,
        sparse_compact_entries=512,
    )
    check(">r\n" + seq + "\n", cfg)


def test_log_store_checkpoint_compacts(rng, tmp_path):
    """Checkpoints force compaction + squeeze; resume bit-identical."""
    import numpy as np
    from conftest import random_dna
    from findkmer_tpu.config import Config
    from findkmer_tpu import pipeline, streaming

    seq = random_dna(rng, 3000, n_prob=0.02)
    p = tmp_path / "in.fa"
    p.write_text(">r\n" + seq + "\n")
    cfg = Config(
        k=18, chunk_len=128, batch_rows=2, sparse_capacity=16384,
        sparse_compact_entries=1024,
    )
    ck = str(tmp_path / "ck")
    a = streaming.stream_count([str(p)], cfg, checkpoint_dir=ck,
                               checkpoint_every=2)
    b = pipeline.count_file(str(p), cfg)
    np.testing.assert_array_equal(a[0], b[0])
    np.testing.assert_array_equal(a[1], b[1])


# --- 2-D (row store) ops: models/counter.py STORE_ROWS path ----------

def test_compact_raw_2d_rows_independent(rng):
    from findkmer_tpu.ops.sparse import compact_raw_2d, store_to_host_2d

    G, C = 4, 64
    hi = rng.integers(0, 3, (G, C)).astype(np.uint32)
    lo = rng.integers(0, 8, (G, C)).astype(np.uint32)
    kill = rng.random((G, C)) < 0.2
    hi = np.where(kill, SENT, hi)
    lo = np.where(kill, SENT, lo)
    shi, slo, scnt, drows = compact_raw_2d(jnp.asarray(hi), jnp.asarray(lo))
    # per-row distinct matches a dict per row
    for g in range(G):
        want = _dict_counts(hi[g], lo[g])
        assert int(drows[g]) == len(want)
    # host merge of the G runs == dict over everything
    codes, counts = store_to_host_2d(shi, slo, scnt)
    want_all = _dict_counts(hi, lo)
    assert dict(zip(codes.tolist(), counts.tolist())) == want_all
    assert (np.diff(codes.astype(np.int64)) > 0).all()


def test_squeeze_2d_preserves_live(rng):
    from findkmer_tpu.ops.sparse import (
        compact_raw_narrow_2d, squeeze_narrow_2d,
    )

    G, C = 4, 128
    lo = rng.integers(0, 32, (G, C)).astype(np.uint32)
    slo, scnt, drows = compact_raw_narrow_2d(jnp.asarray(lo))
    qlo, qcnt = squeeze_narrow_2d(slo, scnt)
    qlo, qcnt = np.asarray(qlo), np.asarray(qcnt)
    for g in range(G):
        d = int(drows[g])
        assert (qcnt[g][:d] > 0).all() and (qcnt[g][d:] == 0).all()
        # live prefix stays sorted by code
        assert (np.diff(qlo[g][:d].astype(np.int64)) > 0).all()


def test_merge_host_runs_numpy_fallback_matches_native(rng):
    from findkmer_tpu.io import native
    from findkmer_tpu.ops.sparse import merge_host_runs

    runs = []
    for _ in range(5):
        codes = np.unique(
            rng.integers(0, 1000, 200).astype(np.uint64)
        )
        counts = rng.integers(1, 100, codes.size).astype(np.int64)
        runs.append((codes, counts))
    want = {}
    for c, n in runs:
        for ci, ni in zip(c.tolist(), n.tolist()):
            want[ci] = want.get(ci, 0) + ni
    got_c, got_n = merge_host_runs(runs)
    assert dict(zip(got_c.tolist(), got_n.tolist())) == want
    if native.available():
        nc, nn = native.merge_runs(runs)
        assert (nc == got_c).all() and (nn == got_n).all()

def test_ordered_finalize_matches_legacy(monkeypatch, rng):
    """The global-order finalize (default) and the legacy row-store
    heap-merge path produce identical spectra — including all-singleton,
    all-multi, and int64-count inputs."""
    import numpy as np

    from findkmer_tpu.config import Config
    from findkmer_tpu.models.counter import KmerCounter
    from findkmer_tpu.pipeline import batches_from_codes

    def spectrum(env_val, seq_codes, k, count_dtype="int32"):
        monkeypatch.setenv("FINDKMER_ORDERED_FINALIZE", env_val)
        cfg = Config(k=k, table_mode="sparse", chunk_len=256,
                     batch_rows=2, sparse_capacity=1 << 16,
                     count_dtype=count_dtype)
        c = KmerCounter(cfg)
        st = c.init_state()
        for b in batches_from_codes(iter([seq_codes]), cfg):
            st = c.step(st, b)
        return c.finalize(st)

    cases = [
        # random (mixed counts), k=21 (wide) and k=12 (narrow)
        (rng.integers(0, 4, 5000).astype(np.uint8), 21, "int32"),
        (rng.integers(0, 4, 5000).astype(np.uint8), 12, "int32"),
        # all-singleton: a de-Bruijn-ish non-repeating stretch
        (rng.permutation(np.arange(4, dtype=np.uint8).repeat(6))[:24],
         21, "int32"),
        # all-multi: AAAA... -> one k-mer, huge count
        (np.zeros(4000, np.uint8), 21, "int32"),
        (rng.integers(0, 4, 3000).astype(np.uint8), 17, "int64"),
    ]
    for seq, k, cdt in cases:
        c1, n1 = spectrum("1", seq, k, cdt)
        c0, n0 = spectrum("0", seq, k, cdt)
        assert np.array_equal(c1, c0), (k, cdt)
        assert np.array_equal(np.asarray(n1), np.asarray(n0)), (k, cdt)
        assert n1.dtype == n0.dtype

def test_finalize_chunks_equals_finalize(rng):
    """finalize_chunks concatenates to exactly finalize()'s output."""
    import numpy as np

    from findkmer_tpu.config import Config
    from findkmer_tpu.models.counter import KmerCounter
    from findkmer_tpu.pipeline import batches_from_codes

    seq = rng.integers(0, 4, 20000).astype(np.uint8)
    for k in (12, 21):
        cfg = Config(k=k, table_mode="sparse", chunk_len=512,
                     batch_rows=2, sparse_capacity=1 << 16)
        c = KmerCounter(cfg)
        st = c.init_state()
        for b in batches_from_codes(iter([seq]), cfg):
            st = c.step(st, b)
        # two independent states (finalize mutates device buffers)
        c2 = KmerCounter(cfg)
        st2 = c2.init_state()
        for b in batches_from_codes(iter([seq]), cfg):
            st2 = c2.step(st2, b)
        codes, counts = c.finalize(st)
        parts = list(c2.finalize_chunks(st2))
        got_codes = np.concatenate([p[0] for p in parts])
        got_counts = np.concatenate([p[1] for p in parts])
        assert np.array_equal(got_codes, codes), k
        assert np.array_equal(got_counts, counts), k

def test_wide_codes_with_all_ones_lo_survive(rng):
    """k-mers whose LOW 32 code bits are all ones (>= 16 trailing T's —
    real poly-T homopolymer runs) must not be dropped: the RLE hole
    test keys on hi for wide stores (regression: lo == 0xFFFFFFFF was
    treated as a sentinel and silently erased such k-mers)."""
    import numpy as np

    from findkmer_tpu.config import Config
    from findkmer_tpu.models.counter import KmerCounter
    from findkmer_tpu.ops.window import code_to_str
    from findkmer_tpu.pipeline import batches_from_codes
    from oracle.scalar import count_kmers_in_text

    base_map = {"A": 0, "C": 1, "G": 2, "T": 3}

    def run(seq_str, k, env=None):
        import os

        if env is not None:
            os.environ["FINDKMER_ORDERED_FINALIZE"] = env
        try:
            cfg = Config(k=k, table_mode="sparse", chunk_len=128,
                         batch_rows=2, sparse_capacity=1 << 14)
            c = KmerCounter(cfg)
            st = c.init_state()
            codes = np.array([base_map[ch] for ch in seq_str], np.uint8)
            for b in batches_from_codes(iter([codes]), cfg):
                st = c.step(st, b)
            fc, fn = c.finalize(st)
            return {code_to_str(int(a), k): int(n)
                    for a, n in zip(fc, fn)}
        finally:
            if env is not None:
                os.environ.pop("FINDKMER_ORDERED_FINALIZE", None)

    # ACGTA + 16 T's + ACGTC: the window ACGTATTTTTTTTTTTTTTTT at k=21
    # has lo == 0xFFFFFFFF; 'T'*16 at k=16 is the all-ones code
    cases = [
        ("ACGTA" + "T" * 16 + "ACGTC", 21),
        ("T" * 40, 16),                       # hi == 0 AND lo == ~0
        ("A" + "T" * 16 + "G" + "T" * 16, 17),
        ("T" * 64, 21),
    ]
    for seq, k in cases:
        want = count_kmers_in_text(seq, k)
        for env in ("1", "0"):
            got = run(seq, k, env=env)
            assert got == want, (seq[:12], k, env)


def test_wide_all_ones_lo_distributed(rng):
    """Same regression through the dp_sparse mesh path (rle_*_2d)."""
    import jax
    import numpy as np

    if len(jax.devices()) < 8:  # --on-device: fewer real cards
        import pytest

        pytest.skip("needs an 8-device mesh")

    from findkmer_tpu.config import Config
    from findkmer_tpu.models.counter import make_counter
    from findkmer_tpu.ops.window import code_to_str
    from findkmer_tpu.pipeline import batches_from_codes
    from oracle.scalar import count_kmers_in_text

    seq = "ACGTA" + "T" * 16 + "ACGTC" + "T" * 40
    base_map = {"A": 0, "C": 1, "G": 2, "T": 3}
    cfg = Config(k=21, table_mode="sparse", chunk_len=64, batch_rows=8,
                 devices=8, sparse_capacity=1 << 14)
    c = make_counter(cfg)
    st = c.init_state()
    codes = np.array([base_map[ch] for ch in seq], np.uint8)
    for b in batches_from_codes(iter([codes]), cfg):
        st = c.step(st, b)
    fc, fn = c.finalize(st)
    got = {code_to_str(int(a), 21): int(n) for a, n in zip(fc, fn)}
    assert got == count_kmers_in_text(seq, 21)

def test_run_coded_hi_wire(rng):
    """The run-coded hi wire (k <= 26 ordered finalize) reconstructs
    codes exactly — boundaries at chunk edges, single-run, many-run,
    and the k > 26 full-hi path all agree with the legacy finalize."""
    import numpy as np

    from findkmer_tpu.config import Config
    from findkmer_tpu.models.counter import KmerCounter
    from findkmer_tpu.pipeline import batches_from_codes

    def spectra_for(seq_codes, k, env):
        import os

        os.environ["FINDKMER_ORDERED_FINALIZE"] = env
        try:
            cfg = Config(k=k, table_mode="sparse", chunk_len=512,
                         batch_rows=2, sparse_capacity=1 << 16)
            c = KmerCounter(cfg)
            st = c.init_state()
            for b in batches_from_codes(iter([seq_codes]), cfg):
                st = c.step(st, b)
            return c.finalize(st)
        finally:
            os.environ.pop("FINDKMER_ORDERED_FINALIZE", None)

    for k in (17, 21, 26, 27):  # 17/21/26 run-coded; 27 full-hi
        seq = rng.integers(0, 4, 30000).astype(np.uint8)
        c1, n1 = spectra_for(seq, k, "1")
        c0, n0 = spectra_for(seq, k, "0")
        assert np.array_equal(c1, c0), k
        assert np.array_equal(np.asarray(n1), np.asarray(n0)), k

def test_multi_chunk_finalize_pull(monkeypatch, rng):
    """Force an 8-chunk finalize pull on a small store: chunk-boundary
    reassembly of run-coded hi and exception counts stays exact."""
    import numpy as np

    from findkmer_tpu.config import Config
    from findkmer_tpu.models.counter import KmerCounter
    from findkmer_tpu.pipeline import batches_from_codes

    seq = np.concatenate([
        rng.integers(0, 4, 20000).astype(np.uint8),
        np.zeros(64, np.uint8),          # poly-A: a multi-count run
        np.full(64, 3, np.uint8),        # poly-T: lo == ~0 codes
    ])

    def run(k, forced):
        if forced:
            monkeypatch.setenv("FINDKMER_FINALIZE_CHUNKS", "8")
        else:
            monkeypatch.delenv("FINDKMER_FINALIZE_CHUNKS",
                               raising=False)
        cfg = Config(k=k, table_mode="sparse", chunk_len=512,
                     batch_rows=2, sparse_capacity=1 << 16)
        c = KmerCounter(cfg)
        st = c.init_state()
        for b in batches_from_codes(iter([seq]), cfg):
            st = c.step(st, b)
        return c.finalize(st)

    for k in (12, 21, 27):
        c8, n8 = run(k, True)
        c1, n1 = run(k, False)
        assert np.array_equal(c8, c1), k
        assert np.array_equal(n8, n1), k


@pytest.mark.heavy
def test_chr_shaped_compaction_ordered_finalize(rng):
    """Chr-scale-SHAPED store exercise (VERDICT round-2 item 6): one
    ladder-size raw buffer (4M slots) through the row compaction and
    the ordered finalize chain, vs a numpy dict.  On the GPU
    (`--on-device`, chip_smoke.py) this validates XLA's lowering of the
    production-size sort shapes."""
    import numpy as np

    from findkmer_tpu.config import Config
    from findkmer_tpu.models.counter import KmerCounter

    k = 21
    n = 1 << 22  # one production ladder rung (4M raw slots)
    hi = rng.integers(0, 1 << 10, n).astype(np.uint64)
    lo = rng.integers(0, 1 << 32, n).astype(np.uint64)
    codes = (hi << np.uint64(32)) | lo
    # salt in heavy duplicates so RLE totals and count exceptions fire
    codes[: n // 4] = codes[0]
    cfg = Config(k=k, sparse_capacity=n,
                 sparse_expected_entries=n)
    c = KmerCounter(cfg)
    st = c.init_state()
    # inject raw codes directly (the extraction path is covered by the
    # oracle tests; this test targets the compaction/finalize shapes)
    import jax.numpy as jnp

    from findkmer_tpu.models.counter import _append
    from findkmer_tpu.ops import sparse as sparse_ops

    hdt = sparse_ops.hi_dtype(k)
    parts = (
        jnp.asarray((codes >> np.uint64(32)).astype(hdt)),
        jnp.asarray((codes & np.uint64(0xFFFFFFFF)).astype(np.uint32)),
    )
    st = st.__class__(raw=_append(st.raw, parts, jnp.int32(0)),
                      fill=n)
    got_c, got_n = c.finalize(st)
    want_c, want_n = np.unique(codes, return_counts=True)
    assert np.array_equal(got_c, want_c)
    assert np.array_equal(got_n, want_n.astype(np.int64))


def test_store_rows_geometry():
    """Adaptive row count: test-scale caps keep G=64; production caps
    climb to the round-4 measured knee at G=262144 (shorter rows sort
    faster through C=512 — bench/probe_rowsort2.py); G always divides
    the cap and every larger ladder value (growth never re-rows)."""
    from findkmer_tpu.models.counter import _store_rows
    from findkmer_tpu.ops.sparse import ladder

    assert _store_rows(4096) == 64
    assert _store_rows(8192) == 64
    assert _store_rows(1 << 20) == 8192
    assert _store_rows(50_331_648) == 262144
    assert _store_rows(1 << 28) == 262144
    for cap0 in (4096, 6144, 8192, 1 << 16, 3 << 15, 1 << 20, 3 << 23):
        cap0 = ladder(cap0)
        g = _store_rows(cap0)
        cap = cap0
        for _ in range(12):  # every growth step stays row-divisible
            assert cap % g == 0, (cap0, g, cap)
            cap = ladder(cap + 1)


@pytest.mark.heavy
def test_large_row_store_multi_compaction_vs_oracle(rng):
    """G >> 64 store geometry: three injected raw rounds drive the
    compact_raw -> compact_counted -> finalize chain at production-class
    row counts (>= 4096; 65536 after the round-4 g_cap raise), exact
    vs a numpy dict (the round-3 adaptive-rows change)."""
    import jax.numpy as jnp

    from findkmer_tpu.config import Config
    from findkmer_tpu.models.counter import KmerCounter, _append
    from findkmer_tpu.ops import sparse as sparse_ops

    k = 21
    n = 1 << 20
    cfg = Config(k=k, sparse_capacity=4 * n,
                 sparse_expected_entries=n,
                 sparse_compact_entries=n)
    c = KmerCounter(cfg)
    assert c._rows >= 4096  # production-class geometry, rule-derived
    st = c.init_state()
    hdt = sparse_ops.hi_dtype(k)
    all_codes = []
    for _ in range(3):
        hi = rng.integers(0, 1 << 10, n).astype(np.uint64)
        lo = rng.integers(0, 1 << 32, n).astype(np.uint64)
        codes = (hi << np.uint64(32)) | lo
        codes[: n // 8] = codes[0]  # salt duplicates for the RLE
        all_codes.append(codes)
        parts = (
            jnp.asarray((codes >> np.uint64(32)).astype(hdt)),
            jnp.asarray(
                (codes & np.uint64(0xFFFFFFFF)).astype(np.uint32)
            ),
        )
        st = st.__class__(
            raw=_append(st.raw, parts, jnp.int32(0)), fill=n,
            store=st.store, store_len=st.store_len,
            distinct=st.distinct,
        )
        st = c.compact(st)  # 1st: compact_raw; later: compact_counted
        assert st.store[0].shape[0] == c._rows
    got_c, got_n = c.finalize(st)
    want_c, want_n = np.unique(np.concatenate(all_codes),
                               return_counts=True)
    assert np.array_equal(got_c, want_c)
    assert np.array_equal(got_n, want_n.astype(np.int64))


@pytest.mark.heavy
def test_large_ladder_dedup_multichunk_finalize(rng, monkeypatch):
    """Repeat-heavy input at cap >= 2^22 (VERDICT round-3 item 7): codes
    drawn from a pool smaller than capacity, injected until the store's
    per-row ENTRY sum exceeds sparse_capacity while true distinct stays
    under it — the exact regime where on-demand cross-row dedup
    (counter._dedup_state) must fire instead of a spurious capacity
    error.  The finalize is forced multi-chunk (FINDKMER_FINALIZE_CHUNKS)
    so the chunked ordered-wire reassembly also runs at G=4096 on CPU."""
    import jax.numpy as jnp

    from findkmer_tpu.config import Config
    from findkmer_tpu.models.counter import KmerCounter, _append
    from findkmer_tpu.ops import sparse as sparse_ops

    monkeypatch.setenv("FINDKMER_FINALIZE_CHUNKS", "4")
    k = 21
    n = 1 << 20
    cap = 1 << 22
    cfg = Config(k=k, sparse_capacity=cap,
                 sparse_expected_entries=n,
                 sparse_compact_entries=n)
    c = KmerCounter(cfg)
    assert c._rows >= 4096  # production-class geometry, rule-derived
    st = c.init_state()
    hdt = sparse_ops.hi_dtype(k)
    # pool of 2^21 distinct codes (< cap): every round re-draws from the
    # pool, so cross-row duplicates accumulate with each compaction
    pool = (
        rng.integers(0, 1 << 10, 1 << 21).astype(np.uint64)
        << np.uint64(32)
    ) | rng.integers(0, 1 << 32, 1 << 21).astype(np.uint64)
    # 5 rounds: the entry sum (~5M) first crosses cap (4.19M) after the
    # LAST compaction, so the dedup fires on the finalize path
    # (_ensure_capacity); the compact-path trigger is covered at small
    # scale by test_capacity_dedup_repetitive_input.
    all_codes = []
    for _ in range(5):
        codes = pool[rng.integers(0, pool.size, n)]
        all_codes.append(codes)
        parts = (
            jnp.asarray((codes >> np.uint64(32)).astype(hdt)),
            jnp.asarray(
                (codes & np.uint64(0xFFFFFFFF)).astype(np.uint32)
            ),
        )
        st = st.__class__(
            raw=_append(st.raw, parts, jnp.int32(0)), fill=n,
            store=st.store, store_len=st.store_len,
            distinct=st.distinct,
        )
        st = c.compact(st)
    # the regime this test exists for: entry sum above capacity, true
    # distinct below it — only on-demand dedup can tell them apart
    want_c, want_n = np.unique(np.concatenate(all_codes),
                               return_counts=True)
    entry_sum = int(np.asarray(st.distinct).sum())
    assert want_c.size <= cap < entry_sum, (want_c.size, entry_sum)
    got_c, got_n = c.finalize(st)
    assert np.array_equal(got_c, want_c)
    assert np.array_equal(got_n, want_n.astype(np.int64))


def test_merge_host_runs_hierarchical_over_256(rng):
    """>256 sorted runs (a G=4096 store pulled row-wise) merge through
    the chunked C passes bit-exactly (round-3 review finding: the
    branch had no oracle test)."""
    import numpy as np

    from findkmer_tpu.ops.sparse import merge_host_runs

    runs = []
    want = {}
    for _ in range(300):
        m = int(rng.integers(0, 40))
        codes = np.unique(rng.integers(0, 5000, m).astype(np.uint64))
        counts = rng.integers(1, 9, codes.size).astype(np.int64)
        runs.append((codes, counts))
        for c, n in zip(codes, counts):
            want[int(c)] = want.get(int(c), 0) + int(n)
    got_c, got_n = merge_host_runs(runs)
    assert got_c.size == len(want)
    assert np.array_equal(got_c, np.array(sorted(want), np.uint64))
    assert np.array_equal(
        got_n, np.array([want[int(c)] for c in got_c], np.int64)
    )


def test_capacity_dedup_repetitive_input(rng):
    """Repeat-heavy input: per-row distinct sums overcount true
    distinct (entries, not k-mers); crossing sparse_capacity now folds
    cross-row duplicates and only errors on the EXACT count (round-3
    review finding).  Exact spectrum preserved."""
    import io as _io

    from findkmer_tpu import pipeline
    from findkmer_tpu.config import Config
    from findkmer_tpu.io.fasta import FastaReader
    from findkmer_tpu.models.counter import KmerCounter
    from oracle.scalar import count_kmers_in_text
    from findkmer_tpu.ops.window import code_to_str

    k = 17
    motif = "".join(rng.choice(list("ACGT")) for _ in range(150))
    seq = motif * 300  # 45 kb, ~170 true distinct k-mers
    text = ">r\n" + seq + "\n"
    cfg = Config(
        k=k, chunk_len=512, batch_rows=4, table_mode="sparse",
        sparse_capacity=600, sparse_compact_entries=2048,
    )
    c = KmerCounter(cfg)
    st = c.init_state()
    for rows in pipeline.batches_from_codes(
        pipeline.code_stream(FastaReader(_io.BytesIO(text.encode()))), cfg
    ):
        st = c.step(st, rows)  # forces many compactions at entries>600
    codes, counts = c.finalize(st)
    got = {code_to_str(int(cd), k): int(ct)
           for cd, ct in zip(codes, counts)}
    assert got == count_kmers_in_text(seq, k)
    # a spectrum GENUINELY over capacity still errors with the exact
    # count in the message
    import pytest as _pytest
    from conftest import random_dna

    big = random_dna(rng, 4000)
    cfg2 = Config(k=k, chunk_len=512, batch_rows=4,
                  table_mode="sparse", sparse_capacity=64,
                  sparse_compact_entries=2048)
    c2 = KmerCounter(cfg2)
    st2 = c2.init_state()
    with _pytest.raises(RuntimeError, match="sparse_capacity"):
        for rows in pipeline.batches_from_codes(
            pipeline.code_stream(
                FastaReader(_io.BytesIO((">r\n" + big + "\n").encode()))
            ), cfg2,
        ):
            st2 = c2.step(st2, rows)
        c2.finalize(st2)


def test_capacity_dedup_repetitive_input_dist(rng):
    """Same as above on the 4-device dp_sparse mesh (per-device
    sub-rows amplify the entry overcount up to R x)."""
    import io as _io

    from findkmer_tpu import pipeline
    from findkmer_tpu.config import Config
    from findkmer_tpu.io.fasta import FastaReader
    from findkmer_tpu.parallel import DistributedCounter, make_mesh
    from test_vs_oracle import oracle_dict, spectrum_to_dict

    k = 17
    motif = "".join(rng.choice(list("ACGT")) for _ in range(150))
    seq = motif * 300
    text = ">r\n" + seq + "\n"
    cfg = Config(
        k=k, chunk_len=256, batch_rows=8, table_mode="sparse",
        sparse_capacity=600, sparse_compact_entries=2048,
    )
    dc = DistributedCounter(cfg, make_mesh(4))
    st = dc.init_state()
    for rows in pipeline.batches_from_codes(
        pipeline.code_stream(FastaReader(_io.BytesIO(text.encode()))), cfg
    ):
        st = dc.step(st, rows)
    spectrum = dc.finalize(st)
    assert spectrum_to_dict(spectrum, k) == oracle_dict(text, k)


@pytest.mark.parametrize("shift", [24, 32])
def test_apply_hi_runs_matches_per_run_loop(rng, shift):
    """The vectorized OR equals a run-by-run loop over every span,
    including spans that start before the first run or inside a run."""
    from findkmer_tpu.ops import sparse as sparse_ops

    n = 500
    ridx = np.unique(rng.integers(1, n, 40))
    ridx = np.concatenate([[0], ridx]) if rng.random() < 0.5 else ridx
    rhi = rng.integers(0, 256, ridx.size).astype(np.uint32)
    base = rng.integers(0, 1 << 24, n).astype(np.uint64)
    for a, m in [(0, n), (0, 1), (3, 7), (ridx[1], 50), (ridx[-1], n -
                 ridx[-1]), (n - 1, 1), (100, 0)]:
        a, m = int(a), int(m)
        want = base[a:a + m].copy()
        for j in range(ridx.size):
            s = max(int(ridx[j]), a)
            t = min(int(ridx[j + 1]) if j + 1 < ridx.size else a + m, a + m)
            if t > s:
                want[s - a:t - a] |= np.uint64(rhi[j]) << np.uint64(shift)
        got = base[a:a + m].copy()
        sparse_ops.apply_hi_runs(got, a, ridx, rhi, shift)
        np.testing.assert_array_equal(got, want)
