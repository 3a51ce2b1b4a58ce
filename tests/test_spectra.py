"""Spectrum merge/diff tools (findkmer merge, findkmer diff)."""

import os
import subprocess
import sys

import pytest

from findkmer_tpu import spectra
from oracle.scalar import count_fasta_file, spectrum_lines

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def test_read_merge_roundtrip(tmp_path, fixtures_dir):
    a = count_fasta_file(os.path.join(fixtures_dir, "tiny.fa"), 4)
    b = count_fasta_file(os.path.join(fixtures_dir, "debruijn4.fa"), 4)
    pa, pb = tmp_path / "a.tsv", tmp_path / "b.tsv"
    pa.write_text("\n".join(spectrum_lines(a, 4)) + "\n")
    pb.write_text("\n".join(spectrum_lines(b, 4)) + "\n")
    merged = spectra.merge_spectra([str(pa), str(pb)])
    want = dict(a)
    for k_, v in b.items():
        want[k_] = want.get(k_, 0) + v
    assert merged == want


def test_diff_spectra():
    assert spectra.diff_spectra({"AA": 1}, {"AA": 1}) == []
    d = spectra.diff_spectra({"AA": 1, "AC": 2}, {"AA": 3})
    assert d == ["AA: 1 != 3", "AC: 2 != 0"]


def test_diff_streaming_matches_dict(tmp_path):
    """diff_sorted_streaming == diff_spectra on sorted inputs (the
    O(buffers) chr-scale path, VERDICT round-2 item 5)."""
    a = {"AAAA": 1, "AACG": 2, "CGTA": 7}
    b = {"AAAA": 1, "AACG": 5, "GGGG": 3}
    pa, pb = tmp_path / "a.tsv", tmp_path / "b.tsv"
    pa.write_text("".join(f"{k}\t{v}\n" for k, v in sorted(a.items())))
    pb.write_text("".join(f"{k}\t{v}\n" for k, v in sorted(b.items())))
    got = list(spectra.diff_sorted_streaming(str(pa), str(pb)))
    assert got == spectra.diff_spectra(a, b)
    # equal files -> no lines
    assert list(spectra.diff_sorted_streaming(str(pa), str(pa))) == []


def test_diff_streaming_unsorted_error(tmp_path):
    p1 = tmp_path / "u.tsv"
    p1.write_text("CCCC\t1\nAAAA\t2\n")  # out of order
    p2 = tmp_path / "s.tsv"
    p2.write_text("AAAA\t2\n")
    with pytest.raises(ValueError, match="not sorted"):
        list(spectra.diff_sorted_streaming(str(p1), str(p2)))


def test_unsorted_error_beats_early_exit(tmp_path):
    """_sorted_lines must raise BEFORE yielding the out-of-order record:
    an early-exiting consumer (query's left==0 break) would otherwise
    accept the unsorted file silently (round-3 review finding)."""
    p = tmp_path / "u.tsv"
    p.write_text("CCCC\t2\nAACC\t1\n")
    with pytest.raises(ValueError, match="not sorted"):
        spectra.query_spectrum(str(p), ["AACC"])


def test_diff_cli_in_memory_and_limit(tmp_path):
    # unsorted inputs: streaming errors with a hint; --in-memory works
    (tmp_path / "u1.tsv").write_text("CCCC\t1\nAAAA\t2\n")
    (tmp_path / "u2.tsv").write_text("AAAA\t2\nCCCC\t9\n")
    r = _cli(["diff", "-i", "u1.tsv", "u2.tsv"], tmp_path)
    assert r.returncode not in (0, 1) and "--in-memory" in r.stderr
    r2 = _cli(["diff", "-i", "u1.tsv", "u2.tsv", "--in-memory"], tmp_path)
    assert r2.returncode == 1 and "CCCC: 1 != 9" in r2.stdout
    # limit: exit code stays 1, overflow reported
    (tmp_path / "s1.tsv").write_text("AAAA\t1\nCCCC\t1\nGGGG\t1\n")
    (tmp_path / "s2.tsv").write_text("AAAA\t2\nCCCC\t2\nGGGG\t2\n")
    r3 = _cli(["diff", "-i", "s1.tsv", "s2.tsv", "--limit", "1"],
              tmp_path)
    assert r3.returncode == 1 and "... and 2 more" in r3.stdout


def test_malformed_line_reported(tmp_path):
    p = tmp_path / "bad.tsv"
    p.write_text("AAAA\t1\ngarbage line\n")
    with pytest.raises(ValueError, match="bad.tsv:2"):
        spectra.read_spectrum(str(p))


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
def test_merge_cli_equals_combined_count(tmp_path, fixtures_dir):
    t = os.path.join(fixtures_dir, "tiny.fa")
    d = os.path.join(fixtures_dir, "debruijn4.fa")
    r1 = _cli(["count", "-i", t, "-k", "4", "-o", "s1.tsv"], tmp_path)
    r2 = _cli(["count", "-i", d, "-k", "4", "-o", "s2.tsv"], tmp_path)
    assert r1.returncode == 0 and r2.returncode == 0, (r1.stderr, r2.stderr)
    rm = _cli(["merge", "-i", "s1.tsv", "s2.tsv"], tmp_path)
    assert rm.returncode == 0, rm.stderr
    rc = _cli(["count", "-i", t, d, "-k", "4"], tmp_path)
    assert rm.stdout == rc.stdout

    # diff: identical -> exit 0; different -> exit 1 with lines
    rd = _cli(["diff", "-i", "s1.tsv", "s1.tsv"], tmp_path)
    assert rd.returncode == 0 and rd.stdout == ""
    rd2 = _cli(["diff", "-i", "s1.tsv", "s2.tsv"], tmp_path)
    assert rd2.returncode == 1 and rd2.stdout


def test_streaming_merge_matches_dict(tmp_path):
    """Streaming k-way merge == dict merge on sorted inputs."""
    import io
    import random
    from findkmer_tpu import spectra

    rng = random.Random(7)
    kmers = sorted({"".join(rng.choice("ACGT") for _ in range(5))
                    for _ in range(200)})
    files = []
    for i in range(3):
        p = tmp_path / f"s{i}.tsv"
        sel = sorted(rng.sample(kmers, 120))
        p.write_text("".join(f"{k}\t{rng.randint(1, 99)}\n" for k in sel))
        files.append(str(p))

    buf = io.BytesIO()
    n = spectra.merge_sorted_streaming(files, buf)
    got = buf.getvalue().decode().splitlines()
    want = list(spectra.spectrum_lines(spectra.merge_spectra(files)))
    assert got == want
    assert n == len(want)


def test_streaming_merge_zeros(tmp_path):
    import io
    from findkmer_tpu import spectra
    from oracle.scalar import all_kmers

    p = tmp_path / "s.tsv"
    p.write_text("AC\t3\nGT\t1\n")
    buf = io.BytesIO()
    spectra.merge_sorted_streaming([str(p)], buf, zeros_k=2)
    got = buf.getvalue().decode().splitlines()
    assert len(got) == 16
    assert got[0] == "AA\t0"
    d = dict(line.split("\t") for line in got)
    assert d["AC"] == "3" and d["GT"] == "1"
    assert [line.split("\t")[0] for line in got] == list(all_kmers(2))


def test_streaming_merge_canonical_zeros(tmp_path):
    """merge -z --canonical interleaves zeros over the canonical code
    space only (ROADMAP: canonical-aware merge -z)."""
    import io
    from findkmer_tpu import spectra
    from oracle.scalar import canonical_kmers

    p = tmp_path / "s.tsv"
    p.write_text("AC\t3\nCG\t1\nTA\t2\n")  # all canonical 2-mers
    buf = io.BytesIO()
    spectra.merge_sorted_streaming([str(p)], buf, zeros_k=2,
                                   canonical=True)
    got = buf.getvalue().decode().splitlines()
    want_kmers = list(canonical_kmers(2))
    assert [line.split("\t")[0] for line in got] == want_kmers
    assert len(want_kmers) == 10  # (16 + 4 palindromes) / 2
    d = dict(line.split("\t") for line in got)
    assert d["AC"] == "3" and d["AA"] == "0" and d["TA"] == "2"

    # non-canonical input k-mer -> clean error (GT folds to AC)
    bad = tmp_path / "bad.tsv"
    bad.write_text("GT\t1\n")
    with pytest.raises(ValueError, match="non-canonical"):
        spectra.merge_sorted_streaming([str(bad)], io.BytesIO(),
                                       zeros_k=2, canonical=True)
    with pytest.raises(ValueError, match="non-canonical"):
        list(spectra.spectrum_lines({"GT": 1}, zeros_k=2, canonical=True))


@pytest.mark.heavy
def test_merge_cli_canonical_zeros_matches_count(tmp_path, fixtures_dir):
    """CLI: merging canonical spectra with -z --canonical equals
    counting the combined input with -z --canonical (both enumerate
    the canonical code space); --in-memory path agrees."""
    t = os.path.join(fixtures_dir, "tiny.fa")
    d = os.path.join(fixtures_dir, "debruijn4.fa")
    for src, out in ((t, "c1.tsv"), (d, "c2.tsv")):
        r = _cli(["count", "-i", src, "-k", "3", "--canonical",
                  "-o", out], tmp_path)
        assert r.returncode == 0, r.stderr
    rm = _cli(["merge", "-i", "c1.tsv", "c2.tsv", "-k", "3", "-z",
               "--canonical"], tmp_path)
    assert rm.returncode == 0, rm.stderr
    rc = _cli(["count", "-i", t, d, "-k", "3", "--canonical", "-z"],
              tmp_path)
    assert rc.returncode == 0, rc.stderr
    assert rm.stdout == rc.stdout
    rim = _cli(["merge", "-i", "c1.tsv", "c2.tsv", "-k", "3", "-z",
                "--canonical", "--in-memory"], tmp_path)
    assert rim.returncode == 0, rim.stderr
    assert rim.stdout == rc.stdout
    # --canonical without -z is a clean error
    rbad = _cli(["merge", "-i", "c1.tsv", "--canonical"], tmp_path)
    assert rbad.returncode != 0


@pytest.mark.heavy
def test_count_canonical_zeros_space(tmp_path, fixtures_dir):
    """count -z --canonical emits exactly the canonical code space, in
    order, matching the oracle's canonical spectrum."""
    from oracle.scalar import canonical_kmers, count_fasta_file
    from oracle.scalar import spectrum_lines as oracle_lines

    t = os.path.join(fixtures_dir, "tiny.fa")
    r = _cli(["count", "-i", t, "-k", "4", "--canonical", "-z"], tmp_path)
    assert r.returncode == 0, r.stderr
    got = r.stdout.splitlines()
    assert [line.split("\t")[0] for line in got] == list(canonical_kmers(4))
    want = oracle_lines(count_fasta_file(t, 4, canonical=True), 4,
                        zeros=True, canonical=True)
    assert got == want


def test_streaming_merge_rejects_unsorted(tmp_path):
    import io
    import pytest
    from findkmer_tpu import spectra

    p = tmp_path / "bad.tsv"
    p.write_text("GT\t1\nAC\t2\n")
    with pytest.raises(ValueError, match="not sorted"):
        spectra.merge_sorted_streaming([str(p)], io.BytesIO())


def test_setops_query_topn(tmp_path):
    """intersect/subtract (kmc_tools semantics), query, topn."""
    import subprocess, sys, os
    a = tmp_path / "a.tsv"
    b = tmp_path / "b.tsv"
    a.write_text("AA\t3\nAC\t1\nGT\t9\n")
    b.write_text("AA\t1\nCC\t4\nGT\t2\n")
    from findkmer_tpu import spectra
    import io

    out = io.BytesIO()
    spectra.intersect_sorted_streaming([str(a), str(b)], out)
    assert out.getvalue() == b"AA\t1\nGT\t2\n"
    out = io.BytesIO()
    spectra.subtract_sorted_streaming([str(a), str(b)], out)
    assert out.getvalue() == b"AA\t2\nAC\t1\nGT\t7\n"
    assert spectra.query_spectrum(str(a), ["gt", "TT"]) == {
        "GT": 9, "TT": 0,
    }
    assert spectra.top_n(str(a), 2) == [("GT", 9), ("AA", 3)]
    # tie on count prefers lexicographically smaller k-mer
    c = tmp_path / "c.tsv"
    c.write_text("AA\t5\nAC\t5\nAG\t5\n")
    assert spectra.top_n(str(c), 2) == [("AA", 5), ("AC", 5)]


def test_merge_op_min_max(tmp_path):
    """merge --op min|max (kmc_tools union counter-calculation modes):
    streaming == in-memory == hand-computed, over PRESENT counters."""
    import io
    from findkmer_tpu import spectra

    a = tmp_path / "a.tsv"
    b = tmp_path / "b.tsv"
    a.write_text("AA\t3\nAC\t1\nGT\t9\n")
    b.write_text("AA\t1\nCC\t4\nGT\t2\n")
    paths = [str(a), str(b)]
    want = {
        "min": b"AA\t1\nAC\t1\nCC\t4\nGT\t2\n",
        "max": b"AA\t3\nAC\t1\nCC\t4\nGT\t9\n",
        "sum": b"AA\t4\nAC\t1\nCC\t4\nGT\t11\n",
    }
    for op, exp in want.items():
        out = io.BytesIO()
        spectra.merge_sorted_streaming(paths, out, op=op)
        assert out.getvalue() == exp, op
        mem = spectra.merge_spectra(paths, op=op)
        got = "".join(f"{k}\t{v}\n" for k, v in sorted(mem.items()))
        assert got.encode() == exp, op
    # CLI: --op min bypasses the C sum fast path
    r = _cli(["merge", "-i", str(a), str(b), "--op", "min"], tmp_path)
    assert r.returncode == 0, r.stderr
    assert r.stdout.encode() == want["min"]


def test_subtract_mode_kmers(tmp_path):
    """subtract --mode kmers drops any k-mer present in another input,
    keeping first-input counts otherwise (kmc_tools kmers_subtract)."""
    import io
    from findkmer_tpu import spectra

    a = tmp_path / "a.tsv"
    b = tmp_path / "b.tsv"
    a.write_text("AA\t3\nAC\t1\nGT\t9\n")
    b.write_text("AA\t1\nCC\t4\nGT\t2\n")
    out = io.BytesIO()
    spectra.subtract_sorted_streaming([str(a), str(b)], out, mode="kmers")
    assert out.getvalue() == b"AC\t1\n"
    # fast binary path agrees (native parser path)
    from findkmer_tpu.io.native import available

    if available():
        fast = io.BytesIO()
        ok = spectra._setop_binary_fast([str(a), str(b)], fast,
                                        "subtract", "\t", mode="kmers")
        if ok is not None:
            assert fast.getvalue() == b"AC\t1\n"
    r = _cli(["subtract", "-i", str(a), str(b), "--mode", "kmers"],
             tmp_path)
    assert r.returncode == 0, r.stderr
    assert r.stdout == "AC\t1\n"


def test_merge_binary_fast_matches_streaming(tmp_path, rng):
    """C fast-path merge is byte-identical to the Python streaming
    merge on sorted inputs, and declines exotic inputs."""
    import io
    import numpy as np
    from findkmer_tpu import spectra
    from findkmer_tpu.io.native import available

    if not available():
        import pytest

        pytest.skip("native lib unavailable")

    def write_spec(path, n, seed):
        r = np.random.default_rng(seed)
        codes = np.unique(r.integers(0, 4**8, n).astype(np.uint64))
        counts = r.integers(1, 1000, codes.size)
        lines = []
        for c, v in zip(codes.tolist(), counts.tolist()):
            kmer = "".join(
                "ACGT"[(c >> (2 * (7 - j))) & 3] for j in range(8)
            )
            lines.append(f"{kmer}\t{v}")
        path.write_text("\n".join(lines) + "\n")

    p1, p2, p3 = (tmp_path / f"s{i}.tsv" for i in range(3))
    write_spec(p1, 5000, 1)
    write_spec(p2, 3000, 2)
    write_spec(p3, 1, 3)
    paths = [str(p1), str(p2), str(p3)]
    fast = io.BytesIO()
    assert spectra.merge_binary_fast(paths, fast)
    slow = io.BytesIO()
    spectra.merge_sorted_streaming(paths, slow)
    assert fast.getvalue() == slow.getvalue()
    # CRLF inputs decline cleanly (nothing written)
    p4 = tmp_path / "crlf.tsv"
    p4.write_bytes(b"AAAAAAAA\t1\r\nAAAAAAAC\t2\r\n")
    out = io.BytesIO()
    assert spectra.merge_binary_fast([str(p4)], out) in (True, False)
    if out.getvalue():
        assert out.getvalue() == b"AAAAAAAA\t1\nAAAAAAAC\t2\n"

def test_revcomp_codes_u64_matches_scalar(rng):
    import numpy as np
    from findkmer_tpu.ops.window import revcomp_code
    from findkmer_tpu.spectra import revcomp_codes_u64

    for k in (1, 2, 4, 8, 15, 21, 31):
        codes = rng.integers(0, 4**k, 64, dtype=np.uint64)
        got = revcomp_codes_u64(codes, k)
        want = np.array([revcomp_code(int(c), k) for c in codes],
                        dtype=np.uint64)
        assert np.array_equal(got, want), f"k={k}"


def test_canonize_runs_matches_oracle(rng):
    import numpy as np
    from findkmer_tpu.ops.window import code_to_str, str_to_code
    from findkmer_tpu.spectra import canonize_runs
    from oracle.scalar import count_kmers_in_text

    k = 5
    seq = "".join("ACGT"[i] for i in rng.integers(0, 4, 3000))
    plain = count_kmers_in_text(seq, k)
    want = count_kmers_in_text(seq, k, canonical=True)
    codes = np.array(sorted(str_to_code(s) for s in plain), dtype=np.uint64)
    counts = np.array([plain[code_to_str(int(c), k)] for c in codes],
                      dtype=np.int64)
    fc, fn = canonize_runs(codes, counts, k)
    got = {code_to_str(int(c), k): int(n) for c, n in zip(fc, fn)}
    assert got == want
    assert np.all(fc[1:] > fc[:-1])  # sorted, distinct


def test_canonize_file_fast_and_fallback(tmp_path, rng):
    """C fast path and the Python dict fallback agree; output is the
    canonical spectrum."""
    import io
    from findkmer_tpu import spectra
    from oracle.scalar import count_kmers_in_text, spectrum_lines

    k = 4
    seq = "".join("ACGT"[i] for i in rng.integers(0, 4, 800))
    plain = count_kmers_in_text(seq, k)
    p = tmp_path / "plain.tsv"
    p.write_text("\n".join(spectrum_lines(plain, k)) + "\n")
    want = "\n".join(
        spectrum_lines(count_kmers_in_text(seq, k, canonical=True), k)
    ) + "\n"

    out = io.BytesIO()
    spectra.canonize_spectrum_file(str(p), out)
    assert out.getvalue().decode() == want

    # lowercase k-mers make the C parser decline -> dict fallback
    p2 = tmp_path / "lower.tsv"
    p2.write_text(
        "\n".join(line.lower() for line in
                  spectrum_lines(plain, k)) + "\n"
    )
    out2 = io.BytesIO()
    spectra.canonize_spectrum_file(str(p2), out2)
    assert out2.getvalue().decode() == want


def test_canonical_setops_and_query(tmp_path):
    """--canonical set ops fold inputs (revcomp counts summed) before
    the op; query folds the probe k-mer."""
    import io
    from findkmer_tpu import spectra

    a = tmp_path / "a.tsv"  # TT folds into AA: canonical a = AA 5, AC 1
    b = tmp_path / "b.tsv"  # canonical b = AA 1, GT(revcomp AC) -> AC 4
    a.write_text("AA\t3\nAC\t1\nTT\t2\n")
    b.write_text("AA\t1\nGT\t4\n")

    out = io.BytesIO()
    spectra.intersect_sorted_streaming([str(a), str(b)], out,
                                       canonical=True)
    assert out.getvalue() == b"AA\t1\nAC\t1\n"
    out = io.BytesIO()
    spectra.subtract_sorted_streaming([str(a), str(b)], out,
                                      canonical=True)
    assert out.getvalue() == b"AA\t4\n"
    # plain ops unchanged by default
    out = io.BytesIO()
    spectra.intersect_sorted_streaming([str(a), str(b)], out)
    assert out.getvalue() == b"AA\t1\n"
    assert spectra.query_spectrum(str(a), ["TT"], canonical=False) == {
        "TT": 2
    }
    c = tmp_path / "canon.tsv"
    c.write_text("AA\t5\nAC\t1\n")
    assert spectra.query_spectrum(str(c), ["TT", "gt"],
                                  canonical=True) == {"TT": 5, "GT": 1}


@pytest.mark.heavy
def test_canonize_cli_matches_count_canonical(tmp_path, fixtures_dir):
    t = os.path.join(fixtures_dir, "tiny.fa")
    r1 = _cli(["count", "-i", t, "-k", "4", "-o", "plain.tsv"], tmp_path)
    r2 = _cli(["count", "-i", t, "-k", "4", "--canonical",
               "-o", "canon.tsv"], tmp_path)
    assert r1.returncode == 0 and r2.returncode == 0, (r1.stderr, r2.stderr)
    rz = _cli(["canonize", "plain.tsv"], tmp_path)
    assert rz.returncode == 0, rz.stderr
    assert rz.stdout == (tmp_path / "canon.tsv").read_text()

@pytest.mark.heavy
def test_histo_from_spectrum(tmp_path, fixtures_dir):
    """histo --from-spectrum == histo recounted from the FASTA."""
    t = os.path.join(fixtures_dir, "tiny.fa")
    r1 = _cli(["count", "-i", t, "-k", "4", "-o", "s.tsv"], tmp_path)
    assert r1.returncode == 0, r1.stderr
    ha = _cli(["histo", "-i", t, "-k", "4"], tmp_path)
    hb = _cli(["histo", "-i", "s.tsv", "-k", "4", "--from-spectrum"],
              tmp_path)
    assert ha.returncode == 0 and hb.returncode == 0, (ha.stderr, hb.stderr)
    assert ha.stdout == hb.stdout and ha.stdout
    # lowercase input exercises the Python fallback parser
    low = tmp_path / "low.tsv"
    low.write_text(
        "".join(line.lower() + "\n"
                for line in (tmp_path / "s.tsv").read_text().splitlines())
    )
    hc = _cli(["histo", "-i", "low.tsv", "--from-spectrum", "-k", "4"],
              tmp_path)
    assert hc.stdout == ha.stdout

def test_multichar_sep_falls_back(tmp_path):
    """A multi-byte --sep must not trip the 1-byte C-path asserts —
    merge/canonize/histo fall back to the Python parsers."""
    import io
    from findkmer_tpu import spectra

    a = tmp_path / "a.tsv"
    a.write_text("AA :: 3\nAC :: 1\nTT :: 2\n")
    out = io.BytesIO()
    assert not spectra.merge_binary_fast([str(a)], out, sep=" :: ")
    out = io.BytesIO()
    spectra.merge_sorted_streaming([str(a)], out, sep=" :: ")
    assert out.getvalue() == b"AA :: 3\nAC :: 1\nTT :: 2\n"
    out = io.BytesIO()
    spectra.canonize_spectrum_file(str(a), out, sep=" :: ")
    assert out.getvalue() == b"AA :: 5\nAC :: 1\n"
    h = spectra.histo_spectrum_file(str(a), max_count=10, sep=" :: ")
    assert h[1] == 1 and h[2] == 1 and h[3] == 1

def test_sort_spectrum_file(tmp_path):
    """findkmer sort: orders, case-folds, and sums duplicates — C-coded
    and text fallback paths agree."""
    import io

    from findkmer_tpu import spectra

    p = tmp_path / "messy.tsv"
    p.write_text("GT\t1\nac\t2\nAC\t3\ngt\t4\nAA\t5\n")
    out = io.BytesIO()
    n = spectra.sort_spectrum_file(str(p), out)
    assert bytes(out.getvalue()) == b"AA\t5\nAC\t5\nGT\t5\n"
    assert n == 3
    # non-ACGT k-mers: text fallback, still sorted + summed
    p2 = tmp_path / "iupac.tsv"
    p2.write_text("NN\t1\nAC\t2\nnn\t3\n")
    out2 = io.BytesIO()
    spectra.sort_spectrum_file(str(p2), out2)
    assert out2.getvalue() == b"AC\t2\nNN\t4\n"
    # sorted output feeds the streaming ops
    sorted_p = tmp_path / "sorted.tsv"
    sorted_p.write_bytes(bytes(out.getvalue()))
    out3 = io.BytesIO()
    spectra.merge_sorted_streaming([str(sorted_p)], out3)
    assert bytes(out3.getvalue()) == b"AA\t5\nAC\t5\nGT\t5\n"


def test_sort_cli(tmp_path):
    p = tmp_path / "u.tsv"
    p.write_text("TTTT\t1\nAAAA\t2\n")
    r = _cli(["sort", "u.tsv"], tmp_path)
    assert r.returncode == 0, r.stderr
    assert r.stdout == "AAAA\t2\nTTTT\t1\n"


@pytest.mark.heavy
def test_sort_transform_knobs(tmp_path):
    """sort --min-count/--max-count/--set-count/--kmers-only (kmc_tools
    transform reduce/set_counts/compact) on both the C-coded and text
    fallback paths."""
    import io

    from findkmer_tpu import spectra

    p = tmp_path / "s.tsv"
    p.write_text("AA\t1\nAC\t3\nGT\t7\nTT\t2\n")
    out = io.BytesIO()
    n = spectra.sort_spectrum_file(str(p), out, min_count=2, max_count=3)
    assert out.getvalue() == b"AC\t3\nTT\t2\n" and n == 2
    out = io.BytesIO()
    spectra.sort_spectrum_file(str(p), out, min_count=2, set_count=1)
    assert out.getvalue() == b"AC\t1\nGT\t1\nTT\t1\n"
    out = io.BytesIO()
    spectra.sort_spectrum_file(str(p), out, kmers_only=True)
    assert out.getvalue() == b"AA\nAC\nGT\nTT\n"
    # text fallback (non-ACGT forces it) honors the same knobs
    p2 = tmp_path / "iupac.tsv"
    p2.write_text("NN\t5\nAC\t1\nGG\t4\n")
    out = io.BytesIO()
    spectra.sort_spectrum_file(str(p2), out, min_count=4)
    assert out.getvalue() == b"GG\t4\nNN\t5\n"
    out = io.BytesIO()
    spectra.sort_spectrum_file(str(p2), out, min_count=4, kmers_only=True)
    assert out.getvalue() == b"GG\nNN\n"
    # all filtered -> empty output, count 0
    out = io.BytesIO()
    assert spectra.sort_spectrum_file(str(p), out, min_count=100) == 0
    assert out.getvalue() == b""
    # CLI surface
    r = _cli(["sort", "s.tsv", "--min-count", "2", "--max-count", "3"],
             tmp_path)
    assert r.returncode == 0, r.stderr
    assert r.stdout == "AC\t3\nTT\t2\n"
    r = _cli(["sort", "s.tsv", "--kmers-only"], tmp_path)
    assert r.returncode == 0, r.stderr
    assert r.stdout == "AA\nAC\nGT\nTT\n"

def test_sort_mixed_lengths_and_k32(tmp_path):
    """sort: mixed-length k-mers take the text path (no length-blind
    code corruption); k >= 32 spectra are preserved, never emptied."""
    import io

    from findkmer_tpu import spectra

    p = tmp_path / "mixed.tsv"
    p.write_text("ACGT\t1\nAC\t2\nA\t3\n")
    out = io.BytesIO()
    n = spectra.sort_spectrum_file(str(p), out)
    assert bytes(out.getvalue()) == b"A\t3\nAC\t2\nACGT\t1\n"
    assert n == 3

    big = "A" * 33
    p2 = tmp_path / "k33.tsv"
    p2.write_text(f"{'T'*33}\t1\n{big}\t2\n")
    out2 = io.BytesIO()
    n2 = spectra.sort_spectrum_file(str(p2), out2)
    assert bytes(out2.getvalue()) == f"{big}\t2\n{'T'*33}\t1\n".encode()
    assert n2 == 2

def test_setop_binary_fast_matches_streaming(tmp_path, rng):
    """Vectorized set-op fast path == the Python line path, on inputs
    large enough to matter; exotic inputs decline to the line path."""
    import io
    import numpy as np

    from findkmer_tpu import spectra
    from findkmer_tpu.io.native import available

    if not available():
        pytest.skip("native lib unavailable")

    def write_spec(path, n, seed):
        r = np.random.default_rng(seed)
        codes = np.unique(r.integers(0, 4**6, n).astype(np.uint64))
        counts = r.integers(1, 50, codes.size)
        lines = []
        for c, v in zip(codes.tolist(), counts.tolist()):
            km = "".join("ACGT"[(c >> (2 * (5 - j))) & 3]
                         for j in range(6))
            lines.append(f"{km}\t{v}")
        path.write_text("\n".join(lines) + "\n")

    a, b, c = (tmp_path / f"s{i}.tsv" for i in range(3))
    write_spec(a, 2000, 1)
    write_spec(b, 1500, 2)
    write_spec(c, 500, 3)
    paths = [str(a), str(b), str(c)]
    for op in ("intersect", "subtract"):
        fast = io.BytesIO()
        ok = spectra._setop_binary_fast(paths, fast, op, "\t")
        assert ok
        slow = io.BytesIO()
        fn = (spectra.intersect_sorted_streaming if op == "intersect"
              else spectra.subtract_sorted_streaming)
        # force the line path by feeding a lowercase copy of the same
        # data (C parser declines lowercase)
        import os

        lows = []
        for p in paths:
            lp = tmp_path / (os.path.basename(p) + ".low")
            lp.write_text(
                "".join(line.lower() + "\n" for line in
                        open(p).read().splitlines())
            )
            lows.append(str(lp))
        fn(lows, slow)
        assert bytes(fast.getvalue()).decode() == \
            slow.getvalue().decode().upper()


@pytest.mark.heavy
def test_gzip_spectrum_inputs(tmp_path):
    """Every spectrum reader accepts gzipped TSVs (magic-byte): merge,
    set ops, query, topn, histo --from-spectrum, canonize, sort."""
    import gzip as gz

    a = tmp_path / "a.tsv.gz"
    b = tmp_path / "b.tsv"
    a.write_bytes(gz.compress(b"AA\t3\nAC\t1\nGT\t9\n"))
    b.write_text("AA\t1\nCC\t4\nGT\t2\n")
    r = _cli(["merge", "-i", str(a), str(b)], tmp_path)
    assert r.returncode == 0, r.stderr
    assert r.stdout == "AA\t4\nAC\t1\nCC\t4\nGT\t11\n"
    r = _cli(["merge", "-i", str(a), str(b), "--in-memory"], tmp_path)
    assert r.stdout == "AA\t4\nAC\t1\nCC\t4\nGT\t11\n"
    r = _cli(["intersect", "-i", str(a), str(b)], tmp_path)
    assert r.stdout == "AA\t1\nGT\t2\n"
    r = _cli(["query", str(a), "GT", "TT"], tmp_path)
    assert r.stdout == "GT\t9\nTT\t0\n"
    r = _cli(["topn", str(a), "-n", "1"], tmp_path)
    assert r.stdout == "GT\t9\n"
    r = _cli(["histo", "-i", str(a), "--from-spectrum", "-k", "2"],
             tmp_path)
    assert r.returncode == 0, r.stderr
    r = _cli(["canonize", str(a)], tmp_path)
    assert r.returncode == 0, r.stderr
    assert r.stdout == "AA\t3\nAC\t10\n"  # GT folds onto AC
    r = _cli(["sort", str(a)], tmp_path)
    assert r.stdout == "AA\t3\nAC\t1\nGT\t9\n"


# ---------------------------------------------------------------- info

def _write_spec(tmp_path, name, pairs, sep="\t"):
    p = tmp_path / name
    p.write_text("".join(f"{k}{sep}{c}\n" for k, c in pairs))
    return str(p)


def test_info_sorted_spectrum(tmp_path):
    p = _write_spec(tmp_path, "a.tsv", [
        ("AAAA", 3), ("AACG", 1), ("CGTT", 7), ("TTTT", 1),
    ])
    d = spectra.info_spectrum_file(p)
    assert d["k"] == 4
    assert d["distinct"] == 4
    assert d["total"] == 12
    assert d["min_count"] == 1 and d["max_count"] == 7
    assert d["singletons"] == 2
    assert d["sorted"] == "yes"
    assert d["acgt_only"] == "yes"
    assert d["canonical"] == "no"  # TTTT > revcomp AAAA


def test_info_canonical_and_unsorted(tmp_path):
    canon = _write_spec(tmp_path, "c.tsv", [("AAAA", 2), ("AACG", 5)])
    d = spectra.info_spectrum_file(canon)
    assert d["canonical"] == "yes"
    uns = _write_spec(tmp_path, "u.tsv", [("CCCC", 1), ("AAAA", 1)])
    d = spectra.info_spectrum_file(uns)
    assert d["sorted"] == "no"
    assert d["distinct"] == 2
    mixed = _write_spec(tmp_path, "m.tsv", [("AA", 1), ("AAAN", 2)])
    d = spectra.info_spectrum_file(mixed)
    assert d["k"] == "2..4"
    assert d["acgt_only"] == "no"


def test_info_empty(tmp_path):
    p = tmp_path / "e.tsv"
    p.write_text("")
    d = spectra.info_spectrum_file(str(p))
    assert d["distinct"] == 0 and d["total"] == 0


def test_info_cli(tmp_path):
    p = _write_spec(tmp_path, "a.tsv", [("ACGT", 2), ("TTTT", 1)])
    r = _cli(["info", p], tmp_path)
    assert r.returncode == 0, r.stderr
    got = dict(line.split("\t") for line in r.stdout.splitlines())
    assert got["distinct"] == "2"
    assert got["total"] == "3"
    r = _cli(["info", p, "--json"], tmp_path)
    import json
    assert json.loads(r.stdout)["distinct"] == 2


# ---------------------------------------------------------- similarity

def _brute_similarity(a: dict, b: dict, k: int):
    import math
    sa, sb = set(a), set(b)
    shared = sa & sb
    union = sa | sb
    j = len(shared) / len(union) if union else 0.0
    keys = union
    smin = sum(min(a.get(x, 0), b.get(x, 0)) for x in keys)
    smax = sum(max(a.get(x, 0), b.get(x, 0)) for x in keys)
    dot = sum(a[x] * b[x] for x in shared)
    na = math.sqrt(sum(v * v for v in a.values()))
    nb = math.sqrt(sum(v * v for v in b.values()))
    return {
        "shared": len(shared), "union": len(union), "jaccard": j,
        "containment_a_in_b": len(shared) / len(sa) if sa else 0.0,
        "containment_b_in_a": len(shared) / len(sb) if sb else 0.0,
        "weighted_jaccard": smin / smax if smax else 0.0,
        "cosine": dot / (na * nb) if na and nb else 0.0,
        "mash_distance": (-math.log(2 * j / (1 + j)) / k) if j else 1.0,
    }


def test_similarity_matches_brute_force(tmp_path):
    import random
    rng = random.Random(7)
    kmers = ["".join(rng.choice("ACGT") for _ in range(6))
             for _ in range(200)]
    a = {k_: rng.randint(1, 9) for k_ in sorted(set(kmers[:120]))}
    b = {k_: rng.randint(1, 9) for k_ in sorted(set(kmers[80:]))}
    pa = _write_spec(tmp_path, "a.tsv", sorted(a.items()))
    pb = _write_spec(tmp_path, "b.tsv", sorted(b.items()))
    got = spectra.similarity_spectra(pa, pb)
    want = _brute_similarity(a, b, 6)
    for key, val in want.items():
        assert got[key] == pytest.approx(val), key
    assert got["distinct_a"] == len(a)
    assert got["total_b"] == sum(b.values())


def test_similarity_streaming_path_matches_binary(tmp_path, monkeypatch):
    import random
    rng = random.Random(3)
    kmers = sorted({"".join(rng.choice("ACGT") for _ in range(5))
                    for _ in range(100)})
    a = [(k_, rng.randint(1, 5)) for k_ in kmers[:70]]
    b = [(k_, rng.randint(1, 5)) for k_ in kmers[40:]]
    pa = _write_spec(tmp_path, "a.tsv", a)
    pb = _write_spec(tmp_path, "b.tsv", b)
    fast = spectra.similarity_spectra(pa, pb)
    monkeypatch.setattr(spectra, "_similarity_binary",
                        lambda *a_, **k_: None)
    slow = spectra.similarity_spectra(pa, pb)
    for key in fast:
        assert fast[key] == pytest.approx(slow[key]), key


def test_similarity_identical_and_disjoint(tmp_path):
    pa = _write_spec(tmp_path, "a.tsv", [("AAAA", 2), ("CCCC", 3)])
    d = spectra.similarity_spectra(pa, pa)
    assert d["jaccard"] == 1.0 and d["cosine"] == pytest.approx(1.0)
    assert d["weighted_jaccard"] == 1.0 and d["mash_distance"] == 0.0
    pb = _write_spec(tmp_path, "b.tsv", [("GGGG", 1), ("TTTT", 4)])
    d = spectra.similarity_spectra(pa, pb)
    assert d["jaccard"] == 0.0 and d["shared"] == 0
    assert d["mash_distance"] == 1.0


def test_similarity_canonical_folds_inputs(tmp_path):
    # plain spectrum vs its canonical fold: identical under --canonical
    plain = _write_spec(
        tmp_path, "p.tsv",
        [("AAAA", 1), ("ACGT", 2), ("GGGG", 5), ("TTTT", 3)],
    )
    canon = _write_spec(
        tmp_path, "c.tsv", [("AAAA", 4), ("ACGT", 2), ("CCCC", 5)],
    )
    d = spectra.similarity_spectra(plain, canon, canonical=True)
    assert d["jaccard"] == 1.0
    assert d["weighted_jaccard"] == 1.0


def test_similarity_cli(tmp_path):
    pa = _write_spec(tmp_path, "a.tsv", [("AAAA", 2), ("CCCC", 3)])
    pb = _write_spec(tmp_path, "b.tsv", [("CCCC", 3), ("GTGT", 1)])
    r = _cli(["similarity", "-i", pa, pb, "--json"], tmp_path)
    assert r.returncode == 0, r.stderr
    import json
    d = json.loads(r.stdout)
    assert d["shared"] == 1 and d["union"] == 3
    assert d["jaccard"] == pytest.approx(1 / 3)


# ------------------------------------------------------------- matrix

def _brute_matrix(dicts, names, sep="\t", min_total=0, min_samples=0):
    union = sorted(set().union(*[set(d) for d in dicts]))
    lines = [sep.join(["kmer"] + names)]
    for km in union:
        row = [d.get(km, 0) for d in dicts]
        if min_total and sum(row) < min_total:
            continue
        if min_samples and sum(c > 0 for c in row) < min_samples:
            continue
        lines.append(sep.join([km] + [str(c) for c in row]))
    return "\n".join(lines) + "\n"


def test_matrix_streaming_matches_bruteforce(tmp_path):
    import io

    a = {"AAAA": 3, "ACGT": 1, "TTTT": 2}
    b = {"ACGT": 5, "CCCC": 1}
    c = {"AAAA": 1}
    paths = []
    for i, d in enumerate((a, b, c)):
        p = tmp_path / f"s{i}.tsv"
        p.write_text("".join(f"{k}\t{v}\n" for k, v in sorted(d.items())))
        paths.append(str(p))
    names = ["s0", "s1", "s2"]
    out = io.BytesIO()
    rows = spectra.matrix_sorted_streaming(paths, out, names)
    assert rows == 4  # union: AAAA ACGT CCCC TTTT
    assert out.getvalue().decode() == _brute_matrix([a, b, c], names)
    # filters
    out = io.BytesIO()
    spectra.matrix_sorted_streaming(paths, out, names, min_total=4)
    assert out.getvalue().decode() == _brute_matrix(
        [a, b, c], names, min_total=4)
    out = io.BytesIO()
    spectra.matrix_sorted_streaming(paths, out, names, min_samples=2)
    assert out.getvalue().decode() == _brute_matrix(
        [a, b, c], names, min_samples=2)
    # name count mismatch is a clean error
    with pytest.raises(ValueError, match="one name per input"):
        spectra.matrix_sorted_streaming(paths, io.BytesIO(), ["x"])
    # unsorted input is refused (streaming contract)
    u = tmp_path / "u.tsv"
    u.write_text("CCCC\t1\nAAAA\t2\n")
    with pytest.raises(ValueError, match="not sorted"):
        spectra.matrix_sorted_streaming(
            [paths[0], str(u)], io.BytesIO(), ["a", "u"])


@pytest.mark.heavy
def test_matrix_cli_and_api(tmp_path, fixtures_dir):
    """CLI matrix of two real count outputs; gz input; stem naming with
    collision de-dup; fk.matrix API parity."""
    t = os.path.join(fixtures_dir, "tiny.fa")
    d = os.path.join(fixtures_dir, "debruijn4.fa")
    r = _cli(["count", "-i", t, "-k", "4", "-o", "a.tsv"], tmp_path)
    assert r.returncode == 0, r.stderr
    r = _cli(["count", "-i", d, "-k", "4", "-o", "b.tsv.gz"], tmp_path)
    assert r.returncode == 0, r.stderr
    r = _cli(["matrix", "-i", "a.tsv", "b.tsv.gz", "-o", "m.tsv"],
             tmp_path)
    assert r.returncode == 0, r.stderr
    got = (tmp_path / "m.tsv").read_text()
    da = count_fasta_file(t, 4)
    db = count_fasta_file(d, 4)
    assert got == _brute_matrix([da, db], ["a", "b"])  # .tsv.gz stripped
    # explicit names + min filters via CLI
    r = _cli(["matrix", "-i", "a.tsv", "b.tsv.gz", "--names", "x,y",
              "--min-samples", "2", "-o", "m2.tsv"], tmp_path)
    assert r.returncode == 0, r.stderr
    assert (tmp_path / "m2.tsv").read_text() == _brute_matrix(
        [da, db], ["x", "y"], min_samples=2)
    # stem collision de-dup: same basename in two dirs
    (tmp_path / "d1").mkdir()
    (tmp_path / "d2").mkdir()
    import shutil
    shutil.copy(tmp_path / "a.tsv", tmp_path / "d1" / "s.tsv")
    shutil.copy(tmp_path / "a.tsv", tmp_path / "d2" / "s.tsv")
    r = _cli(["matrix", "-i", "d1/s.tsv", "d2/s.tsv", "-o", "m3.tsv"],
             tmp_path)
    assert r.returncode == 0, r.stderr
    hdr = (tmp_path / "m3.tsv").read_text().splitlines()[0]
    assert hdr == "kmer\ts\ts.2"
    # API
    import findkmer_tpu as fk

    rows = fk.matrix([str(tmp_path / "a.tsv"), str(tmp_path / "b.tsv.gz")],
                     str(tmp_path / "m4.tsv"))
    assert (tmp_path / "m4.tsv").read_text() == got
    assert rows == len(got.splitlines()) - 1


# ---------------------------------------------------------------- expr

def _brute_expr(text, dicts):
    """Reference evaluator: same grammar over plain dicts."""
    import re

    toks = re.findall(r"[A-Za-z_][A-Za-z0-9_]*|[-+*~()]", text) + [None]
    pos = [0]

    def cur():
        return toks[pos[0]]

    def adv():
        pos[0] += 1

    def apply(op, a, b):
        out = {}
        for km in set(a) | set(b):
            ca, cb = a.get(km), b.get(km)
            if op == "+":
                out[km] = (ca or 0) + (cb or 0)
            elif op == "*" and ca is not None and cb is not None:
                out[km] = min(ca, cb)
            elif op == "-" and ca is not None and cb is None:
                out[km] = ca
            elif op == "~" and ca is not None and ca - (cb or 0) > 0:
                out[km] = ca - (cb or 0)
        return out

    def factor():
        if cur() == "(":
            adv()
            n = expr()
            adv()  # ')'
            return n
        n = dicts[cur()]
        adv()
        return n

    def term():
        n = factor()
        while cur() == "*":
            adv()
            n = apply("*", n, factor())
        return n

    def expr():
        n = term()
        while cur() in ("+", "-", "~"):
            op = cur()
            adv()
            n = apply(op, n, term())
        return n

    return expr()


def test_expr_matches_bruteforce(rng, tmp_path):
    kmers = ["".join(rng.choice(list("ACGT")) for _ in range(5))
             for _ in range(60)]
    dicts = {}
    for name in ("A", "B", "C"):
        sel = sorted({kmers[int(i)] for i in rng.integers(0, 60, 35)})
        dicts[name] = {km: int(rng.integers(1, 9)) for km in sel}
        (tmp_path / f"{name}.tsv").write_text(
            "".join(f"{km}\t{c}\n" for km, c in sorted(
                dicts[name].items()))
        )
    inputs = {n: str(tmp_path / f"{n}.tsv") for n in dicts}
    for text in ("A + B", "A * B", "A - B", "A ~ B",
                 "A + B * C",            # precedence: * first
                 "(A + B) - C", "(A ~ B) * (B + C)",
                 "A - B - C", "A"):
        got = dict(
            (km.decode(), c)
            for km, c in spectra.eval_expression(text, inputs)
        )
        assert got == _brute_expr(text, dicts), text
    # errors: unknown name, bad token, trailing, missing paren
    import pytest as _pytest

    for bad, msg in (("A + D", "not a defined input"),
                     ("A +", "expected a name"),
                     ("A B", "trailing"),
                     ("(A + B", "missing"),
                     ("A % B", "unexpected")):
        with _pytest.raises(ValueError, match=msg):
            spectra.eval_expression(bad, inputs)


def test_expr_random_trees_match_bruteforce(rng, tmp_path):
    """Randomized expression fuzz: 25 random operator trees (depth <= 4,
    all four operators, random parenthesization) over four random
    spectra, each checked against the plain-dict evaluator — the fixed
    9-expression list above can't cover operator interleavings."""
    kmers = ["".join(rng.choice(list("ACGT")) for _ in range(6))
             for _ in range(80)]
    dicts = {}
    for name in ("A", "B", "C", "D"):
        sel = sorted({kmers[int(i)] for i in rng.integers(0, 80, 40)})
        dicts[name] = {km: int(rng.integers(1, 9)) for km in sel}
        (tmp_path / f"{name}.tsv").write_text(
            "".join(f"{km}\t{c}\n" for km, c in sorted(dicts[name].items()))
        )
    inputs = {n: str(tmp_path / f"{n}.tsv") for n in dicts}

    def gen(depth):
        if depth == 0 or rng.integers(3) == 0:
            return str(rng.choice(list("ABCD")))
        a, b = gen(depth - 1), gen(depth - 1)
        op = str(rng.choice(["+", "*", "-", "~"]))
        e = f"{a} {op} {b}"
        return f"({e})" if rng.integers(2) else e

    for _ in range(25):
        text = gen(int(rng.integers(1, 5)))
        got = dict(
            (km.decode(), c)
            for km, c in spectra.eval_expression(text, inputs)
        )
        assert got == _brute_expr(text, dicts), text


@pytest.mark.heavy
def test_expr_cli_matches_subcommands(tmp_path, fixtures_dir):
    """expr 'A+B' == merge; 'A*B' == intersect; 'A~B' == subtract
    --mode counters; 'A-B' == subtract --mode kmers (byte-identical)."""
    t = os.path.join(fixtures_dir, "tiny.fa")
    d = os.path.join(fixtures_dir, "debruijn4.fa")
    _cli(["count", "-i", t, "-k", "4", "-o", "a.tsv"], tmp_path)
    _cli(["count", "-i", d, "-k", "4", "-o", "b.tsv"], tmp_path)
    pairs = [
        (["expr", "A + B", "-i", "A=a.tsv", "B=b.tsv"],
         ["merge", "-i", "a.tsv", "b.tsv"]),
        (["expr", "A * B", "-i", "A=a.tsv", "B=b.tsv"],
         ["intersect", "-i", "a.tsv", "b.tsv"]),
        (["expr", "A ~ B", "-i", "A=a.tsv", "B=b.tsv"],
         ["subtract", "-i", "a.tsv", "b.tsv", "--mode", "counters"]),
        (["expr", "A - B", "-i", "A=a.tsv", "B=b.tsv"],
         ["subtract", "-i", "a.tsv", "b.tsv", "--mode", "kmers"]),
    ]
    for expr_args, sub_args in pairs:
        re_ = _cli(expr_args, tmp_path)
        rs = _cli(sub_args, tmp_path)
        assert re_.returncode == 0 and rs.returncode == 0
        assert re_.stdout == rs.stdout, expr_args[1]
    # canonical folding matches the canonical subcommand too
    re_ = _cli(["expr", "A * B", "--canonical",
                "-i", "A=a.tsv", "B=b.tsv"], tmp_path)
    rs = _cli(["intersect", "-i", "a.tsv", "b.tsv", "--canonical"],
              tmp_path)
    assert re_.stdout == rs.stdout
    # a parse error must not truncate an existing output
    (tmp_path / "out.tsv").write_text("precious\n")
    r = _cli(["expr", "A +", "-i", "A=a.tsv", "-o", "out.tsv"],
             tmp_path)
    assert r.returncode == 2
    assert (tmp_path / "out.tsv").read_text() == "precious\n"


@pytest.mark.heavy
def test_matrix_from_sequences(tmp_path, fixtures_dir):
    """matrix -k counts each sequence input first (one sample per
    input) — equals counting separately then matrixing the spectra."""
    t = os.path.join(fixtures_dir, "tiny.fa")
    d = os.path.join(fixtures_dir, "debruijn4.fa")
    r = _cli(["matrix", "-i", t, d, "-k", "4", "--names", "t,d",
              "-o", "mseq.tsv"], tmp_path)
    assert r.returncode == 0, r.stderr
    da = count_fasta_file(t, 4)
    db = count_fasta_file(d, 4)
    assert (tmp_path / "mseq.tsv").read_text() == _brute_matrix(
        [da, db], ["t", "d"])
    # canonical counting via -k
    r = _cli(["matrix", "-i", t, t, "-k", "4", "--canonical",
              "--names", "a,b", "-o", "mc.tsv"], tmp_path)
    assert r.returncode == 0, r.stderr
    dc = count_fasta_file(t, 4, canonical=True)
    assert (tmp_path / "mc.tsv").read_text() == _brute_matrix(
        [dc, dc], ["a", "b"])
    # --canonical without -k is a clean error (spectrum inputs)
    (tmp_path / "s.tsv").write_text("AAAA\t1\n")
    r = _cli(["matrix", "-i", "s.tsv", "s.tsv", "--canonical"], tmp_path)
    assert r.returncode == 2 and "needs -k" in r.stderr


@pytest.mark.heavy
def test_matrix_from_sequences_custom_sep(tmp_path, fixtures_dir):
    """matrix -k --sep: temp spectra are written AND parsed with the
    requested separator (round-3 review finding: they diverged)."""
    t = os.path.join(fixtures_dir, "tiny.fa")
    r = _cli(["matrix", "-i", t, "-k", "4", "--sep", ",",
              "--names", "t", "-o", "m.csv"], tmp_path)
    assert r.returncode == 0, r.stderr
    got = (tmp_path / "m.csv").read_text()
    da = count_fasta_file(t, 4)
    assert got == _brute_matrix([da], ["t"], sep=",")


def test_dict_path_size_guard(tmp_path, monkeypatch):
    """read_spectrum (the unsorted-input fallback) must refuse inputs
    past the dict cap with a sort-it-first error instead of silently
    building a multi-GB dict (VERDICT round-3 weak #6)."""
    from findkmer_tpu import spectra

    p = tmp_path / "unsorted.tsv"
    # unsorted on purpose: the streaming path must not pick it up
    p.write_text("TTTT\t1\nAAAA\t2\nCCCC\t3\nGGGG\t4\nACGT\t5\n")
    monkeypatch.setenv("FINDKMER_DICT_MAX", "3")
    with pytest.raises(ValueError, match="findkmer sort"):
        spectra.read_spectrum(str(p))
    monkeypatch.setenv("FINDKMER_DICT_MAX", "100")
    assert spectra.read_spectrum(str(p))["ACGT"] == 5


def test_query_sums_duplicate_keys_and_reaches_later_keys(tmp_path):
    """Duplicate adjacent keys are legal in third-party files (merge
    sums them); the early exit must not fire before later queried
    k-mers or before a duplicate of the last one (round-5 review)."""
    p = tmp_path / "d.tsv"
    p.write_text("AAAA\t1\nAAAA\t2\nCCCC\t5\nCCCC\t6\nGGGG\t9\n")
    got = spectra.query_spectrum(str(p), ["AAAA", "CCCC"])
    assert got == {"AAAA": 3, "CCCC": 11}


def test_topn_nonpositive_n(tmp_path):
    p = tmp_path / "s.tsv"
    p.write_text("AAAA\t3\nCCCC\t1\n")
    assert spectra.top_n(str(p), 0) == []
    assert spectra.top_n(str(p), -2) == []


def test_canonize_and_histo_handle_k_beyond_31(tmp_path):
    """k > 31 spectra (assembly tooling uses k=51+) must take the
    string-level fallback, not silently produce empty output
    (round-5 review: _infer_k's None conflated 'no data' with
    'k out of range')."""
    import io as _io

    import numpy as np

    a = "A" * 51
    t = "T" * 51
    p = tmp_path / "k51.tsv"
    p.write_text(f"{a}\t3\n{'C' * 51}\t2\n")
    out = _io.BytesIO()
    n = spectra.canonize_spectrum_file(str(p), out)
    assert n == 2
    text = out.getvalue().decode()
    # canonical(A^51) = min(A^51, T^51) = A^51, so counts survive
    assert f"{a}\t3" in text
    assert t not in text
    h = spectra.histo_spectrum_file(str(p), max_count=10)
    assert int(h[3]) == 1 and int(h[2]) == 1


def test_merge_zeros_rejects_mismatched_k(tmp_path):
    """merge -z with a -k that doesn't match the file's k used to
    exhaust the zeros enumeration and silently garble the output
    (round-5 review)."""
    import io as _io

    p = tmp_path / "k8.tsv"
    p.write_text("AAAACCCC\t2\n")
    out = _io.BytesIO()
    with pytest.raises(ValueError, match="enumeration"):
        spectra.merge_sorted_streaming(
            [str(p)], out, zeros_k=4
        )
    with pytest.raises(ValueError, match="enumeration"):
        list(spectra.spectrum_lines({"AAAACCCC": 2}, zeros_k=4))
