"""FASTA reader + encoder tests (SURVEY.md §4.2)."""

import io
import os

import numpy as np
import pytest

from findkmer_tpu.io.encode import (
    INVALID,
    encode_bytes,
    decode_codes,
    pack_2bit,
    unpack_2bit,
)
from findkmer_tpu.io.fasta import FastaReader, read_records
from oracle.scalar import parse_fasta_text


def _records_from_text(text, block_size=1 << 22):
    r = FastaReader(io.BytesIO(text.encode()), block_size=block_size)
    return [(h, s.decode()) for h, s in r.records()]


CASES = [
    ">a\nACGT\n",
    ">a\nACGT\n>b\nTTTT\n",
    ">a desc here\nACGT\nACGT\n\n>b\n\n>c\nGG\n",
    "ACGT\nTTTT\n",                      # headerless
    ">only_header\n",
    ">a\nACGT",                           # no trailing newline
    ">a\r\nAC\r\nGT\r\n>b\r\nTT\r\n",     # CRLF
    ">empty1\n>empty2\n>c\nACGT\n",
    "",
]


@pytest.mark.parametrize("text", CASES)
@pytest.mark.parametrize("block_size", [7, 64, 1 << 22])
def test_reader_matches_oracle_parser(text, block_size):
    got = _records_from_text(text, block_size)
    want = [(h, s) for h, s in parse_fasta_text(text)]
    assert got == want


def test_reader_tiny_blocks_split_header():
    # header split across many blocks
    text = ">" + "h" * 100 + "\nACGTACGT\n>b2\nTT\n"
    got = _records_from_text(text, block_size=3)
    assert got == [("h" * 100, "ACGTACGT"), ("b2", "TT")]


def test_reader_fixture_files(fixtures_dir):
    for name in ("ecoli_frag.fa", "multi.fa", "tiny.fa", "debruijn4.fa"):
        path = os.path.join(fixtures_dir, name)
        got = [(h, s.decode()) for h, s in read_records(path)]
        with open(path) as f:
            want = parse_fasta_text(f.read())
        assert got == want


def test_encode_lut():
    codes = encode_bytes(b"ACGTacgtNnRX>\n ")
    assert codes[:8].tolist() == [0, 1, 2, 3, 0, 1, 2, 3]
    assert (codes[8:] == INVALID).all()


def test_encode_backends_agree(rng):
    from findkmer_tpu.io import native

    data = rng.integers(0, 256, 100000, dtype=np.uint8).tobytes()
    np_codes = encode_bytes(data, prefer_native=False)
    if native.available():
        nat_codes = encode_bytes(data, prefer_native=True)
        np.testing.assert_array_equal(np_codes, nat_codes)
    else:
        pytest.skip("native encoder not built")


def test_pack_unpack_roundtrip(rng):
    for n in (0, 1, 3, 4, 7, 8, 9, 1000, 4097):
        codes = rng.integers(0, 5, n).astype(np.uint8)
        packed, validmask, m = pack_2bit(codes)
        assert m == n
        back = unpack_2bit(packed, validmask, m)
        np.testing.assert_array_equal(back, codes)


def test_native_packed_matches_numpy(rng):
    from findkmer_tpu.io import native

    if not native.available():
        pytest.skip("native encoder not built")
    data = rng.integers(0, 256, 12345, dtype=np.uint8)
    codes = encode_bytes(data.tobytes(), prefer_native=False)
    p1, v1, n1 = pack_2bit(codes)
    p2, v2, n2 = native.encode_packed(data)
    assert n1 == n2
    np.testing.assert_array_equal(p1, p2)
    np.testing.assert_array_equal(v1, v2)
    assert native.count_valid(data) == int((codes < 4).sum())


def test_decode_codes():
    assert decode_codes(np.array([0, 1, 2, 3, 4], np.uint8)) == b"ACGTN"


def test_reader_blank_prefix_no_phantom_record(tmp_path):
    """Blank/whitespace lines before the first '>' must not create a
    phantom empty anonymous record (round-2 advisor finding)."""
    from findkmer_tpu.io.fasta import read_records

    p = tmp_path / "blank.fa"
    p.write_text("\n  \n\t\n>r1\nACGT\n")
    recs = read_records(str(p))
    assert len(recs) == 1
    assert recs[0] == ("r1", b"ACGT")

    # leading whitespace before headerless sequence still yields one record
    p2 = tmp_path / "headerless.fa"
    p2.write_text("\n\nACGTACGT\n")
    recs2 = read_records(str(p2))
    assert len(recs2) == 1
    assert recs2[0] == ("", b"ACGTACGT")

    # whitespace-only file: no records at all
    p3 = tmp_path / "empty.fa"
    p3.write_text("\n \n")
    assert read_records(str(p3)) == []


def test_reader_cr_only_line_endings(tmp_path):
    """Classic-Mac (lone-CR) FASTA parses to the same records as its
    LF twin — before round 5 the header scan waited for a '\\n' that
    never came, re-buffered the whole file, and emitted an empty
    spectrum."""
    from findkmer_tpu.io.fasta import read_records

    lf = tmp_path / "lf.fa"
    cr = tmp_path / "cr.fa"
    crlf = tmp_path / "crlf.fa"
    body = ">r1\nACGTACGT\nGGTT\n>r2\nTTTTACGT\n"
    lf.write_text(body)
    cr.write_bytes(body.replace("\n", "\r").encode())
    crlf.write_bytes(body.replace("\n", "\r\n").encode())
    want = read_records(str(lf))
    assert read_records(str(cr)) == want
    assert read_records(str(crlf)) == want
    assert want[0] == ("r1", b"ACGTACGTGGTT")


def test_prefetch_consumer_exception_cleans_up(tmp_path):
    """A consumer that raises mid-stream must not leak the producer
    thread or leave the batch generator (and its reader) open."""
    import threading
    import time as _time

    from findkmer_tpu import pipeline

    closed = {"v": False}

    def batches():
        try:
            for i in range(1000):
                yield np.full((2, 64), i % 5, np.uint8)
        finally:
            closed["v"] = True

    before = threading.active_count()
    it = pipeline.prefetch_to_device(
        batches(), depth=2, put=lambda b: b
    )
    with pytest.raises(RuntimeError):
        for j, b in enumerate(it):
            if j == 3:
                raise RuntimeError("consumer died")
    it.close()  # generator finalization runs the cleanup
    deadline = _time.time() + 10
    while threading.active_count() > before and _time.time() < deadline:
        _time.sleep(0.02)
    assert threading.active_count() == before, "producer thread leaked"
    assert closed["v"], "batch generator (reader) was not closed"


@pytest.mark.parametrize("cc", ["/nonexistent/cc", "false"])
def test_native_build_reports_failure(monkeypatch, capsys, cc):
    """A failed build (missing compiler, compiler error) says why, on
    stderr and through load_error()."""
    from findkmer_tpu.io import native

    monkeypatch.setattr(native, "_error", "")
    monkeypatch.setattr(native, "_CC", cc)
    assert not native.build(quiet=False)
    assert cc in native.load_error()
    assert cc in capsys.readouterr().err


def test_native_build_reports_timeout(monkeypatch):
    import subprocess

    from findkmer_tpu.io import native

    def slow(cmd, **kw):
        raise subprocess.TimeoutExpired(cmd, kw["timeout"])

    monkeypatch.setattr(native, "_error", "")
    monkeypatch.setattr(native.subprocess, "run", slow)
    assert not native.build()
    assert "timed out" in native.load_error()


def test_native_load_reports_bad_library(monkeypatch, tmp_path):
    from findkmer_tpu.io import native

    bad = tmp_path / "libfindkmer_encode.so"
    bad.write_bytes(b"not an ELF file")
    for name, value in (("_lib", None), ("_load_attempted", False),
                        ("_error", ""), ("_lib_path", lambda: bad)):
        monkeypatch.setattr(native, name, value)
    assert not native.available()
    assert str(bad) in native.load_error()
