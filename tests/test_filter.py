"""`findkmer filter` — read filtering by spectrum membership, checked
against a per-read oracle (oracle.scalar counting)."""

import os
import subprocess
import sys

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _cli(args, tmp_path, expect_rc=0):
    env = dict(os.environ)
    env["JAX_PLATFORMS"] = "cpu"
    env["PYTHONPATH"] = REPO
    r = subprocess.run(
        [sys.executable, "-m", "findkmer_tpu.cli"] + args,
        capture_output=True, text=True, env=env, cwd=str(tmp_path),
        timeout=300,
    )
    if expect_rc is not None:
        assert r.returncode == expect_rc, r.stderr
    return r


def test_window_codes_host_matches_oracle(rng):
    import numpy as np

    from findkmer_tpu.filter import window_codes_host
    from findkmer_tpu.ops.window import str_to_code
    from oracle.scalar import count_kmers_in_text

    seq = "".join(rng.choice(list("ACGTN")) for _ in range(500))
    k = 7
    codes, valid = window_codes_host(seq.encode(), k)
    want = count_kmers_in_text(seq, k)
    got = {}
    from findkmer_tpu.ops.window import code_to_str

    for c, v in zip(codes, valid):
        if v:
            s = code_to_str(int(c), k)
            got[s] = got.get(s, 0) + 1
    assert got == want


def _oracle_hits(seq, k, spectrum_kmers, canonical=False):
    from oracle.scalar import canonical_str

    hits = windows = 0
    s = seq.upper()
    for i in range(len(s) - k + 1):
        w = s[i : i + k]
        if any(ch not in "ACGT" for ch in w):
            continue
        windows += 1
        if canonical:
            w = canonical_str(w)
        if w in spectrum_kmers:
            hits += 1
    return hits, windows


@pytest.mark.parametrize("canonical", [False, True])
def test_filter_spec_hits_oracle(rng, canonical):
    from findkmer_tpu.filter import FilterSpec

    k = 5
    kmers = {"".join(rng.choice(list("ACGT")) for _ in range(k))
             for _ in range(40)}
    if canonical:
        from oracle.scalar import canonical_str

        kmers = {canonical_str(km) for km in kmers}
    spec_path = None

    import tempfile

    with tempfile.NamedTemporaryFile("w", suffix=".tsv",
                                     delete=False) as f:
        for km in sorted(kmers):
            f.write(f"{km}\t1\n")
        spec_path = f.name
    try:
        spec = FilterSpec.load(spec_path, canonical=canonical)
        for _ in range(20):
            seq = "".join(
                rng.choice(list("ACGTN")) for _ in range(rng.integers(3, 60))
            )
            got = spec.hits(seq.encode())
            want = _oracle_hits(seq, k, kmers, canonical)
            assert got == want, seq
    finally:
        os.unlink(spec_path)


@pytest.mark.heavy
def test_filter_cli_fastq_roundtrip(tmp_path):
    """FASTQ in, FASTQ out: passing records byte-identical (quality
    preserved); --invert keeps the complement; counts on stderr."""
    reads = [
        ("@r1", "ACGTACGTAC", "IIIIIIIIII"),   # contains ACGTA
        ("@r2", "GGGGGGGGGG", "JJJJJJJJJJ"),
        ("@r3", "NNACGTANNN", "KKKKKKKKKK"),   # one valid hit window
        ("@r4", "TTTTTTTTTT", "LLLLLLLLLL"),
    ]
    fq = tmp_path / "r.fastq"
    fq.write_text("".join(f"{h}\n{s}\n+\n{q}\n" for h, s, q in reads))
    (tmp_path / "spec.tsv").write_text("ACGTA\t3\n")

    r = _cli(["filter", "-i", "r.fastq", "--spectrum", "spec.tsv",
              "-o", "kept.fastq"], tmp_path)
    kept = (tmp_path / "kept.fastq").read_text()
    assert kept == "@r1\nACGTACGTAC\nIIIIIIIIII\n".replace(
        "IIIIIIIIII", "IIIIIIIIII"
    ).replace("ACGTACGTAC\n", "ACGTACGTAC\n+\n") \
        + "@r3\nNNACGTANNN\n+\nKKKKKKKKKK\n"
    assert "kept 2/4" in r.stderr

    r = _cli(["filter", "-i", "r.fastq", "--spectrum", "spec.tsv",
              "--invert", "-o", "dropped.fastq"], tmp_path)
    dropped = (tmp_path / "dropped.fastq").read_text()
    assert "@r2" in dropped and "@r4" in dropped and "@r1" not in dropped

    # min-frac: r1 has 6 valid windows, 2 hits (ACGTA at 0 and 4) ->
    # frac 1/3; min-frac 0.5 drops it, keeps r3 (1/1)
    r = _cli(["filter", "-i", "r.fastq", "--spectrum", "spec.tsv",
              "--min-frac", "0.5", "-o", "frac.fastq"], tmp_path)
    frac = (tmp_path / "frac.fastq").read_text()
    assert "@r3" in frac and "@r1" not in frac


@pytest.mark.heavy
def test_filter_exit_code_nothing_kept(tmp_path):
    """grep convention (documented in cli.main): exit 1 when no read
    passed the filter, 0 when any did, 2 for trouble."""
    (tmp_path / "r.fa").write_text(">a\nGGGGGGGG\n")
    (tmp_path / "spec.tsv").write_text("ACGTA\t1\n")
    r = _cli(["filter", "-i", "r.fa", "--spectrum", "spec.tsv",
              "-o", "k.fa"], tmp_path, expect_rc=1)
    assert "kept 0/1" in r.stderr
    # paired: same contract at the pair level
    _write_fastq(tmp_path / "R1.fastq", [("@a/1", "GGGGGGGG")])
    _write_fastq(tmp_path / "R2.fastq", [("@a/2", "CCCCCCCC")])
    r = _cli(["filter", "-i", "R1.fastq", "R2.fastq", "--paired",
              "--spectrum", "spec.tsv", "-o", "o1.fq,o2.fq"],
             tmp_path, expect_rc=1)
    assert "kept 0/1 read pairs" in r.stderr


@pytest.mark.heavy
def test_filter_cli_fasta_and_canonical(tmp_path):
    fa = tmp_path / "r.fa"
    fa.write_text(">a\nACGTAAAAA\n>b\nCCCCCCCC\n>c first\nTACGT\n")
    # spectrum contains only TACGT; canonical match folds ACGTA==TACGT
    (tmp_path / "spec.tsv").write_text("TACGT\t1\n")
    r = _cli(["filter", "-i", "r.fa", "--spectrum", "spec.tsv",
              "-o", "kept.fa"], tmp_path)
    assert (tmp_path / "kept.fa").read_text() == ">c first\nTACGT\n"
    r = _cli(["filter", "-i", "r.fa", "--spectrum", "spec.tsv",
              "--canonical", "-o", "kept2.fa"], tmp_path)
    # canonical: ACGTA (in read a) folds to min(ACGTA, TACGT) = ACGTA;
    # spectrum TACGT folds to ACGTA too -> read a now passes
    kept2 = (tmp_path / "kept2.fa").read_text()
    assert ">a" in kept2 and ">c first" in kept2 and ">b" not in kept2

@pytest.mark.heavy
def test_filter_gz_output_and_multiline_rejection(tmp_path):
    import gzip

    fq = tmp_path / "r.fastq"
    fq.write_text("@r1\nACGTA\n+\nIIIII\n")
    (tmp_path / "spec.tsv").write_text("ACGTA\t1\n")
    _cli(["filter", "-i", "r.fastq", "--spectrum", "spec.tsv",
          "-o", "kept.fastq.gz"], tmp_path)
    with gzip.open(tmp_path / "kept.fastq.gz") as f:
        assert f.read() == b"@r1\nACGTA\n+\nIIIII\n"

    # wrapped (multi-line) FASTQ: clean error, not silent misparse
    bad = tmp_path / "wrapped.fastq"
    bad.write_text("@r1\nACGT\nACGT\n+\nIIII\nIIII\n")
    r = _cli(["filter", "-i", "wrapped.fastq", "--spectrum", "spec.tsv"],
             tmp_path, expect_rc=2)
    assert "multi-line FASTQ" in r.stderr

    # typo'd input must not truncate an existing output file
    out = tmp_path / "precious.fastq"
    out.write_text("@old\nAAAA\n+\nIIII\n")
    r = _cli(["filter", "-i", "missing.fastq", "--spectrum", "spec.tsv",
              "-o", "precious.fastq"], tmp_path, expect_rc=2)
    assert out.read_text() == "@old\nAAAA\n+\nIIII\n"


@pytest.mark.heavy
def test_filter_canonical_threshold_after_fold(tmp_path):
    """--canonical --min-count: the threshold sees the SUMMED canonical
    count of a revcomp pair."""
    fa = tmp_path / "r.fa"
    fa.write_text(">a\nACGTA\n")
    # ACGTA 2 + TACGT 2 fold to canonical ACGTA 4 >= 3
    (tmp_path / "spec.tsv").write_text("ACGTA\t2\nTACGT\t2\n")
    r = _cli(["filter", "-i", "r.fa", "--spectrum", "spec.tsv",
              "--canonical", "--min-count", "3", "-o", "kept.fa"],
             tmp_path)
    assert (tmp_path / "kept.fa").read_text() == ">a\nACGTA\n"
    # without folding, each entry alone misses the threshold
    # (nothing kept -> grep-style exit 1)
    r = _cli(["filter", "-i", "r.fa", "--spectrum", "spec.tsv",
              "--min-count", "3", "-o", "kept2.fa"], tmp_path,
             expect_rc=1)
    assert (tmp_path / "kept2.fa").read_text() == ""

@pytest.mark.parametrize("native_on", [True, False])
def test_hits_batch_equals_per_read(rng, native_on, monkeypatch):
    """hits_batch over a mixed batch == per-read oracle, including
    reads shorter than k, empty reads, all-N reads, and batch
    boundaries (the 'N' join must not leak windows across reads).
    Covers both the OpenMP C scan and the numpy fallback."""
    import numpy as np
    import tempfile

    from findkmer_tpu.filter import FilterSpec
    from findkmer_tpu.io import native as native_mod

    if not native_on:
        monkeypatch.setattr(native_mod, "available", lambda: False)
    elif not native_mod.available():
        pytest.skip("native lib unavailable")

    k = 5
    kmers = {"".join(rng.choice(list("ACGT")) for _ in range(k))
             for _ in range(30)}
    with tempfile.NamedTemporaryFile("w", suffix=".tsv",
                                     delete=False) as f:
        for km in sorted(kmers):
            f.write(f"{km}\t1\n")
        path = f.name
    try:
        spec = FilterSpec.load(path)
        reads = [b"", b"A", b"N" * 10,
                 b"ACGT"]  # < k: zero windows
        for _ in range(30):
            reads.append(
                "".join(rng.choice(list("ACGTN"))
                        for _ in range(rng.integers(0, 40))).encode()
            )
        hits, windows = spec.hits_batch(reads)
        for r, h, w in zip(reads, hits, windows):
            want = _oracle_hits(r.decode(), k, kmers)
            assert (int(h), int(w)) == want, r
    finally:
        os.unlink(path)

def test_fastq_block_reader_edges(tmp_path):
    """Block reader: CRLF, empty seq/header-adjacent cases, records
    straddling block boundaries, truncated tail, unterminated EOF."""
    from findkmer_tpu.filter import _fastq_records_block

    # CRLF + empty sequence read + unterminated final line
    p = tmp_path / "a.fastq"
    p.write_bytes(
        b"@r1\r\nACGT\r\n+\r\nIIII\r\n@r2\n\n+\n\n@r3\nGG\n+\nII"
    )
    recs = list(_fastq_records_block(str(p)))
    assert [s for s, _ in recs] == [b"ACGT", b"", b"GG"]
    assert recs[0][1] == b"@r1\r\nACGT\r\n+\r\nIIII\r\n"
    assert recs[2][1] == b"@r3\nGG\n+\nII\n"

    # truncated record (2 of 4 lines) raises
    p2 = tmp_path / "b.fastq"
    p2.write_bytes(b"@r1\nACGT\n")
    import pytest

    with pytest.raises(ValueError, match="truncated"):
        list(_fastq_records_block(str(p2)))

    # record straddling the 4 MB block boundary stays intact
    import numpy as np

    big_q = b"I" * (1 << 22)  # quality line larger than one block
    p3 = tmp_path / "c.fastq"
    p3.write_bytes(
        b"@r1\n" + b"A" * (1 << 22) + b"\n+\n" + big_q +
        b"\n@r2\nCC\n+\nII\n"
    )
    recs = list(_fastq_records_block(str(p3)))
    assert len(recs) == 2
    assert recs[0][0] == b"A" * (1 << 22)
    assert recs[1][0] == b"CC"

def test_fastq_block_reader_blank_lines_and_linear(tmp_path):
    """Blank lines between records are tolerated (FastqReader parity);
    a record spanning many blocks parses linearly and intact."""
    from findkmer_tpu.filter import _fastq_records_block

    p = tmp_path / "b.fastq"
    p.write_bytes(
        b"\n\n@r1\nACGT\n+\nIIII\n\r\n@r2\nGG\n+\nII\n\n"
    )
    recs = list(_fastq_records_block(str(p)))
    assert [s for s, _ in recs] == [b"ACGT", b"GG"]

    import time

    big = tmp_path / "long.fastq"
    n = 48 << 20  # 48 MB seq + 48 MB quality: 12+ blocks per line
    with open(big, "wb") as f:
        f.write(b"@long\n")
        f.write(b"A" * n)
        f.write(b"\n+\n")
        f.write(b"I" * n)
        f.write(b"\n@tail\nCC\n+\nII\n")
    t0 = time.perf_counter()
    recs = list(_fastq_records_block(str(big)))
    dt = time.perf_counter() - t0
    assert len(recs) == 2 and len(recs[0][0]) == n
    assert recs[1][0] == b"CC"
    # linear parse of 96 MB is seconds even at this VM's ~17 MB/s
    # fresh-page fault rate; the quadratic rescan regression this
    # guards against (re-joining the carry per 4 MB block) takes
    # minutes.  Generous bound: machine noise must not flake it.
    assert dt < 60, f"long-read parse took {dt:.1f}s (quadratic?)"


# ---------------------------------------------------------------------
# device engine (filter_device.py): bit-for-bit vs the host scorer
# ---------------------------------------------------------------------

@pytest.mark.parametrize("k,canonical", [
    (5, False), (8, True), (15, False), (16, False),
    (21, False), (21, True), (24, False),
])
def test_device_filter_matches_host(rng, k, canonical):
    """The device sort-merge scorer == the host scan over every k mode
    (narrow u32, wide u16-hi, wide u32-hi) incl. canonical folding and
    the multi-device-batch path (tiny batch geometry forces several
    _filter_step launches per call)."""
    import numpy as np

    from findkmer_tpu import spectra
    from findkmer_tpu.filter import FilterSpec
    from findkmer_tpu.filter_device import DeviceFilter
    from findkmer_tpu.ops.window import str_to_code

    kms = {"".join(rng.choice(list("ACGT")) for _ in range(k))
           for _ in range(150)}
    codes = np.array(sorted(str_to_code(s) for s in kms), np.uint64)
    if canonical:
        codes = np.unique(
            np.minimum(codes, spectra.revcomp_codes_u64(codes, k))
        )
    spec = FilterSpec(k=k, codes=codes, canonical=canonical)
    reads = []
    for _ in range(200):
        L = int(rng.integers(1, 220))
        r = "".join(rng.choice(list("ACGTN")) for _ in range(L))
        if L > k and rng.random() < 0.5:  # embed a member k-mer
            km = sorted(kms)[int(rng.integers(0, len(kms)))]
            p = int(rng.integers(0, L - k))
            r = r[:p] + km + r[p + k:]
        reads.append(r.encode())
    hh, wh = spec.hits_batch(reads)
    dev = DeviceFilter(spec, batch_rows=2, chunk_len=4096)
    hd, wd = dev.hits_batch(reads)
    assert (hh == hd).all() and (wh == wd).all()
    assert hh.sum() > 0  # embedded members actually hit


def test_device_filter_edges(rng):
    import numpy as np

    from findkmer_tpu.filter import FilterSpec
    from findkmer_tpu.filter_device import DeviceFilter

    spec0 = FilterSpec(k=8, codes=np.empty(0, np.uint64))
    d0 = DeviceFilter(spec0, batch_rows=2, chunk_len=4096)
    h, w = d0.hits_batch([b"ACGTACGTACGT"])
    assert int(h[0]) == 0 and int(w[0]) == 5
    d1 = DeviceFilter(FilterSpec(k=8, codes=np.array([0], np.uint64)),
                      batch_rows=2, chunk_len=4096)
    h, w = d1.hits_batch([])
    assert h.size == 0
    h, w = d1.hits_batch([b"ACG", b"N" * 50, b"A" * 50])
    assert list(w) == [0, 0, 43] and list(h) == [0, 0, 43]


def test_device_attribution_native_matches_numpy(rng, monkeypatch):
    """DeviceFilter's two host-attribution legs (C fk_filter_bitmap_hits
    vs numpy unpackbits+_read_spans) agree exactly, including lowercase
    bases, all-N reads, reads shorter than k, and empty reads."""
    import numpy as np

    from findkmer_tpu.filter import FilterSpec
    from findkmer_tpu.filter_device import DeviceFilter
    from findkmer_tpu.io import native as native_mod
    from findkmer_tpu.ops.window import str_to_code

    if not native_mod.available():
        pytest.skip("native lib unavailable")
    k = 7
    kms = {"".join(rng.choice(list("ACGT")) for _ in range(k))
           for _ in range(60)}
    codes = np.array(sorted(str_to_code(s) for s in kms), np.uint64)
    spec = FilterSpec(k=k, codes=codes)
    reads = [b"", b"ACG", b"N" * 30, b"acgtacgtACGTNNacgt"]
    for _ in range(100):
        L = int(rng.integers(0, 120))
        reads.append("".join(
            rng.choice(list("ACGTNacgt")) for _ in range(L)
        ).encode())
    dev = DeviceFilter(spec, batch_rows=2, chunk_len=2048)
    hn, wn = dev.hits_batch(reads)
    monkeypatch.setattr(native_mod, "available", lambda: False)
    hp, wp = dev.hits_batch(reads)
    assert (hn == hp).all() and (wn == wp).all()
    assert hn.sum() > 0 or wn.sum() > 0


@pytest.mark.heavy
def test_filter_cli_engine_device(tmp_path):
    """--engine device produces byte-identical output to --engine host
    at the CLI surface (CPU backend exercises the same jit)."""
    reads = [
        ("@r1", "ACGTACGTAC", "IIIIIIIIII"),
        ("@r2", "GGGGGGGGGG", "JJJJJJJJJJ"),
        ("@r3", "NNACGTANNN", "KKKKKKKKKK"),
    ]
    fq = tmp_path / "r.fastq"
    fq.write_text("".join(f"{h}\n{s}\n+\n{q}\n" for h, s, q in reads))
    (tmp_path / "spec.tsv").write_text("ACGTA\t3\n")
    _cli(["filter", "-i", "r.fastq", "--spectrum", "spec.tsv",
          "--engine", "host", "-o", "h.fastq"], tmp_path)
    _cli(["filter", "-i", "r.fastq", "--spectrum", "spec.tsv",
          "--engine", "device", "-o", "d.fastq"], tmp_path)
    assert (tmp_path / "h.fastq").read_bytes() == \
        (tmp_path / "d.fastq").read_bytes()


# ---------------------------------------------------------------------
# paired-end filtering
# ---------------------------------------------------------------------

def _write_fastq(path, reads):
    path.write_text(
        "".join(f"{h}\n{s}\n+\n{'I' * len(s)}\n" for h, s in reads)
    )


@pytest.mark.heavy
def test_filter_paired_any_both_invert(tmp_path):
    """Pairs are kept/dropped together; outputs stay index-synced."""
    # spectrum k-mer ACGTA; pair1: only R1 hits; pair2: neither;
    # pair3: both hit
    r1 = [("@p1/1", "ACGTAGGGGG"), ("@p2/1", "GGGGGGGGGG"),
          ("@p3/1", "ACGTACCCCC")]
    r2 = [("@p1/2", "TTTTTTTTTT"), ("@p2/2", "CCCCCCCCCC"),
          ("@p3/2", "AAACGTAAAA")]
    _write_fastq(tmp_path / "R1.fastq", r1)
    _write_fastq(tmp_path / "R2.fastq", r2)
    (tmp_path / "spec.tsv").write_text("ACGTA\t1\n")

    def run(extra):
        res = _cli(["filter", "-i", "R1.fastq", "R2.fastq", "--paired",
                    "--spectrum", "spec.tsv",
                    "-o", "o1.fastq,o2.fastq"] + extra, tmp_path)
        return ((tmp_path / "o1.fastq").read_text(),
                (tmp_path / "o2.fastq").read_text(), res.stderr)

    o1, o2, err = run([])
    assert "@p1/1" in o1 and "@p3/1" in o1 and "@p2/1" not in o1
    assert "@p1/2" in o2 and "@p3/2" in o2 and "@p2/2" not in o2
    assert "kept 2/3 read pairs" in err
    o1, o2, err = run(["--pair-mode", "both"])
    assert "@p3/1" in o1 and "@p1/1" not in o1
    assert "kept 1/3 read pairs" in err
    o1, o2, _ = run(["--invert"])
    assert "@p2/1" in o1 and "@p1/1" not in o1 and "@p3/1" not in o1
    # quality lines preserved verbatim in both mates
    assert "+\nIIIIIIIIII\n" in o1 and "+\nIIIIIIIIII\n" in o2


def test_filter_paired_errors(tmp_path):
    _write_fastq(tmp_path / "R1.fastq", [("@a/1", "ACGTA")])
    _write_fastq(tmp_path / "R2.fastq",
                 [("@a/2", "ACGTA"), ("@b/2", "ACGTA")])
    (tmp_path / "spec.tsv").write_text("ACGTA\t1\n")
    r = _cli(["filter", "-i", "R1.fastq", "R2.fastq", "--paired",
              "--spectrum", "spec.tsv", "-o", "a.fq,b.fq"],
             tmp_path, expect_rc=2)
    assert "differ in read count" in r.stderr
    r = _cli(["filter", "-i", "R1.fastq", "--paired",
              "--spectrum", "spec.tsv", "-o", "a.fq,b.fq"],
             tmp_path, expect_rc=2)
    assert "exactly two inputs" in r.stderr
    r = _cli(["filter", "-i", "R1.fastq", "R2.fastq", "--paired",
              "--spectrum", "spec.tsv"], tmp_path, expect_rc=2)
    assert "OUT_R1,OUT_R2" in r.stderr


@pytest.mark.heavy
def test_filter_paired_device_matches_host(tmp_path, rng):
    import numpy as np

    reads1, reads2 = [], []
    for i in range(60):
        s1 = "".join(rng.choice(list("ACGTN"))
                     for _ in range(int(rng.integers(6, 80))))
        s2 = "".join(rng.choice(list("ACGTN"))
                     for _ in range(int(rng.integers(6, 80))))
        reads1.append((f"@r{i}/1", s1))
        reads2.append((f"@r{i}/2", s2))
    _write_fastq(tmp_path / "R1.fastq", reads1)
    _write_fastq(tmp_path / "R2.fastq", reads2)
    (tmp_path / "spec.tsv").write_text("ACGTA\t1\nGGGGG\t2\n")
    for mode in ("any", "both"):
        # random reads may keep nothing (exit 1); the engines must
        # agree on the exit code too
        rh = _cli(["filter", "-i", "R1.fastq", "R2.fastq", "--paired",
                   "--pair-mode", mode, "--spectrum", "spec.tsv",
                   "--engine", "host", "-o", "h1.fq,h2.fq"], tmp_path,
                  expect_rc=None)
        rd = _cli(["filter", "-i", "R1.fastq", "R2.fastq", "--paired",
                   "--pair-mode", mode, "--spectrum", "spec.tsv",
                   "--engine", "device", "-o", "d1.fq,d2.fq"], tmp_path,
                  expect_rc=None)
        assert rh.returncode == rd.returncode
        assert rh.returncode in (0, 1), rh.stderr
        assert (tmp_path / "h1.fq").read_bytes() == \
            (tmp_path / "d1.fq").read_bytes()
        assert (tmp_path / "h2.fq").read_bytes() == \
            (tmp_path / "d2.fq").read_bytes()


def test_filter_file_pipeline_many_flushes(rng, tmp_path, monkeypatch):
    """Cross-flush pipelining (depth 2): a tiny device-batch geometry
    forces ~25 flushes through begin/finish; output must be
    byte-identical to the host engine and in input order."""
    import functools

    from findkmer_tpu import filter as filter_mod
    from findkmer_tpu import filter_device

    reads = []
    for i in range(1000):
        L = int(rng.integers(1, 200))
        reads.append(("@r%d" % i,
                      "".join(rng.choice(list("ACGTN")) for _ in range(L))))
    fq = tmp_path / "r.fastq"
    fq.write_text("".join(f"{h}\n{s}\n+\n{'I' * len(s)}\n"
                          for h, s in reads))
    kmers = {"".join(rng.choice(list("ACGT")) for _ in range(7))
             for _ in range(64)}
    (tmp_path / "spec.tsv").write_text(
        "".join(f"{km}\t1\n" for km in sorted(kmers)))
    spec = filter_mod.FilterSpec.load(str(tmp_path / "spec.tsv"))

    monkeypatch.setattr(
        filter_device, "DeviceFilter",
        functools.partial(filter_device.DeviceFilter,
                          batch_rows=2, chunk_len=2048),
    )
    out_d = tmp_path / "d.fastq"
    with open(out_d, "wb") as f:
        kept_d, seen_d = filter_mod.filter_file(
            str(fq), f, spec, engine="device")
    out_h = tmp_path / "h.fastq"
    with open(out_h, "wb") as f:
        kept_h, seen_h = filter_mod.filter_file(
            str(fq), f, spec, engine="host")
    assert (kept_d, seen_d) == (kept_h, seen_h)
    assert out_d.read_bytes() == out_h.read_bytes()
    assert seen_d == 1000


# ------------------------------------------------- offsets (fast) flow
def _legacy_records(path):
    from findkmer_tpu.filter import _fastq_records_block

    return list(_fastq_records_block(path))


def _offset_records(path, block):
    from findkmer_tpu.filter import _fastq_blocks

    out = []
    for data, ss, se, rs, re_ in _fastq_blocks(path, block_bytes=block):
        b = data.tobytes()
        out.extend(
            (b[int(a):int(c)], b[int(x):int(y)])
            for a, c, x, y in zip(ss, se, rs, re_)
        )
    return out


@pytest.mark.parametrize("block", [64, 4096])
def test_fastq_scan_offsets_matches_legacy_parser(tmp_path, block):
    """The C record scanner (fk_fastq_scan / _fastq_blocks) and the
    numpy block parser must agree on every record's (seq, raw) spans —
    adversarial geometry: blanks between records, CRLF, empty reads,
    records straddling tiny block boundaries, unterminated final
    line."""
    from findkmer_tpu.io import native

    if not native.available():
        pytest.skip("native library not built")
    text = (
        b"@r0 first\nACGTNacgt\n+\nIIIIIIIII\n"
        b"\n\n"                       # blanks where a header is expected
        b"@r1\n\n+\n\n"               # empty read
        b"@r2\r\nACGT\r\n+\r\nIII!\r\n"  # CRLF
        b"@r3 long\n" + b"ACGT" * 200 + b"\n+\n" + b"I" * 800 + b"\n"
        b"@r4\nGG\n+\nII"             # unterminated final line
    )
    p = tmp_path / "t.fastq"
    p.write_bytes(text)
    assert _offset_records(str(p), block) == _legacy_records(str(p))


def test_fastq_scan_offsets_fuzz_block_sizes(tmp_path, rng):
    """Randomized cross-diff of the C scanner vs the numpy parser:
    random read lengths (incl. empty), random CRLF per record, blank
    lines between records, headers with spaces — across block sizes
    chosen to straddle records at every line position (round-4 review
    made this check ad hoc; this pins it)."""
    from findkmer_tpu.io import native

    if not native.available():
        pytest.skip("native library not built")
    parts = []
    for i in range(120):
        L = int(rng.integers(0, 200))
        seq = bytes(rng.choice(list(b"ACGTNacgt"), L))
        qual = bytes(rng.choice(list(b"!IJ~"), L))
        eol = b"\r\n" if rng.integers(2) else b"\n"
        parts.append(
            b"@f" + str(i).encode() + b" x" + eol + seq + eol + b"+"
            + eol + qual + eol
        )
        if rng.integers(4) == 0:
            parts.append(eol)
    text = b"".join(parts)
    p = tmp_path / "fuzz.fastq"
    p.write_bytes(text)
    want = _legacy_records(str(p))
    for block in (37, 251, 1 << 12, 1 << 20):
        assert _offset_records(str(p), block) == want, block


def test_fastq_scan_offsets_errors(tmp_path):
    from findkmer_tpu.io import native

    if not native.available():
        pytest.skip("native library not built")
    bad = tmp_path / "bad.fastq"
    bad.write_bytes(b"@r\nACGT\nTTTT\n+\nIIIIIIII\n")
    with pytest.raises(ValueError, match="multi-line"):
        _offset_records(str(bad), 4096)
    trunc = tmp_path / "trunc.fastq"
    trunc.write_bytes(b"@r\nACGT\n+\nIIII\n@r2\nGG\n")
    with pytest.raises(ValueError, match="truncated"):
        _offset_records(str(trunc), 4096)


@pytest.mark.heavy
def test_filter_fast_flow_byte_identical(tmp_path, rng, monkeypatch):
    """The offsets-based zero-copy flow (FINDKMER_FILTER_FAST=1, the
    default) and the list-based flow must produce byte-identical
    output and counts for BOTH engines across threshold combos."""
    import functools
    import io

    from findkmer_tpu import filter as filter_mod
    from findkmer_tpu import filter_device
    from findkmer_tpu.io import native

    if not native.available():
        pytest.skip("native library not built")
    reads = []
    for i in range(800):
        L = int(rng.integers(0, 150))
        reads.append(("@q%d" % i,
                      "".join(rng.choice(list("ACGTN")) for _ in range(L))))
    fq = tmp_path / "r.fastq"
    fq.write_text("".join(f"{h}\n{s}\n+\n{'I' * len(s)}\n"
                          for h, s in reads))
    kmers = {"".join(rng.choice(list("ACGT")) for _ in range(6))
             for _ in range(128)}
    (tmp_path / "spec.tsv").write_text(
        "".join(f"{km}\t1\n" for km in sorted(kmers)))
    spec = filter_mod.FilterSpec.load(str(tmp_path / "spec.tsv"))
    monkeypatch.setattr(
        filter_device, "DeviceFilter",
        functools.partial(filter_device.DeviceFilter,
                          batch_rows=2, chunk_len=2048),
    )

    def run(fast, engine, **kw):
        monkeypatch.setenv("FINDKMER_FILTER_FAST", "1" if fast else "0")
        out = io.BytesIO()
        kept, seen = filter_mod.filter_file(
            str(fq), out, spec, engine=engine, **kw)
        return kept, seen, out.getvalue()

    # small blocks force MULTI-SEGMENT flushes (several blocks' offsets
    # gathered into one device batch / one host scoring round)
    monkeypatch.setenv("FINDKMER_FILTER_BLOCK", "8192")
    for kw in (dict(), dict(min_hits=2), dict(min_frac=0.5),
               dict(invert=True), dict(min_hits=2, min_frac=0.25)):
        ref = run(False, "host", **kw)
        for fast, engine in ((True, "host"), (True, "device"),
                             (False, "device")):
            got = run(fast, engine, **kw)
            assert got == ref, (kw, fast, engine)


@pytest.mark.heavy
def test_filter_paired_fast_flow_byte_identical(tmp_path, rng,
                                                monkeypatch):
    """Paired offsets flow vs the list-based paired flow: identical
    outputs on both sides, both engines, any/both/invert combos; the
    mate files deliberately have different read lengths per index so
    the two scored streams advance unevenly."""
    import functools
    import io

    import numpy as np

    from findkmer_tpu import filter as filter_mod
    from findkmer_tpu import filter_device
    from findkmer_tpu.io import native

    if not native.available():
        pytest.skip("native library not built")

    def make(path, seed):
        r = np.random.default_rng(seed)
        lines = []
        for i in range(600):
            L = int(r.integers(0, 120))
            s = "".join(r.choice(list("ACGTN"), L))
            lines.append(f"@p{i}/{seed}\n{s}\n+\n{'J' * L}\n")
        path.write_text("".join(lines))

    r1, r2 = tmp_path / "R1.fastq", tmp_path / "R2.fastq"
    make(r1, 1)
    make(r2, 2)
    kmers = {"".join(rng.choice(list("ACGT"), 6)) for _ in range(200)}
    (tmp_path / "s.tsv").write_text(
        "".join(f"{km}\t1\n" for km in sorted(kmers)))
    spec = filter_mod.FilterSpec.load(str(tmp_path / "s.tsv"))
    monkeypatch.setattr(
        filter_device, "DeviceFilter",
        functools.partial(filter_device.DeviceFilter,
                          batch_rows=2, chunk_len=2048),
    )
    monkeypatch.setenv("FINDKMER_FILTER_BLOCK", "8192")

    def run(fast, engine, **kw):
        monkeypatch.setenv("FINDKMER_FILTER_FAST", "1" if fast else "0")
        o1, o2 = io.BytesIO(), io.BytesIO()
        kept, seen = filter_mod.filter_file_paired(
            str(r1), str(r2), o1, o2, spec, engine=engine, **kw)
        return kept, seen, o1.getvalue(), o2.getvalue()

    for kw in (dict(), dict(pair_mode="both"), dict(invert=True),
               dict(min_hits=2, min_frac=0.3)):
        ref = run(False, "host", **kw)
        for fast, engine in ((True, "host"), (True, "device")):
            got = run(fast, engine, **kw)
            assert got == ref, (kw, fast, engine)

    # mismatched read counts must raise the same error
    r3 = tmp_path / "R3.fastq"
    r3.write_text(r2.read_text() + "@extra\nACGT\n+\nIIII\n")
    for fast in (True, False):
        monkeypatch.setenv("FINDKMER_FILTER_FAST", "1" if fast else "0")
        with pytest.raises(ValueError, match="differ in read count"):
            filter_mod.filter_file_paired(
                str(r1), str(r3), io.BytesIO(), io.BytesIO(), spec,
                engine="host")
