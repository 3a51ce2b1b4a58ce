"""SAM/BAM input: reader semantics + oracle-diff vs equivalent FASTA.

Contract (findkmer_tpu/io/sam.py docstring): every primary record with a
stored sequence is one read; secondary/supplementary and SEQ-'*' records
are skipped; reverse-strand records are reverse-complemented back to the
original read orientation (samtools-fasta semantics)."""

import gzip
import io
import os
import struct
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

from findkmer_tpu.io.sam import BamReader, SamReader, _COMP
from findkmer_tpu.io.fastq import sniff_format, sniff_head


def revcomp(s: str) -> str:
    return s.encode().translate(_COMP)[::-1].decode()


def make_sam(records, header=True) -> bytes:
    """records: (qname, flag, seq[, qual]) tuples -> SAM text."""
    lines = []
    if header:
        lines += ["@HD\tVN:1.6\tSO:unsorted", "@SQ\tSN:chr1\tLN:100000"]
    for rec in records:
        qname, flag, seq = rec[:3]
        qual = rec[3] if len(rec) > 3 else (
            "*" if seq == "*" else "I" * len(seq)
        )
        lines.append(
            "\t".join(
                [qname, str(flag), "chr1", "1", "60", f"{len(seq)}M"
                 if seq != "*" else "*", "*", "0", "0", seq, qual]
            )
        )
    return ("\n".join(lines) + "\n").encode()


_NIB16 = b"=ACMGRSVTWYHKDBN"


def make_bam(records, bgzf_chunks=1) -> bytes:
    """records: (qname, flag, seq) triples -> BAM bytes.

    seq '*' encodes as l_seq=0.  bgzf_chunks>1 splits the stream into
    several gzip members (BGZF-style concatenation)."""
    body = io.BytesIO()
    body.write(b"BAM\x01")
    text = b"@HD\tVN:1.6\n"
    body.write(struct.pack("<i", len(text)))
    body.write(text)
    body.write(struct.pack("<i", 1))  # n_ref
    name = b"chr1\x00"
    body.write(struct.pack("<i", len(name)))
    body.write(name)
    body.write(struct.pack("<i", 100000))
    for rec in records:
        qname, flag, seq = rec[:3]
        raw_qual = rec[3] if len(rec) > 3 else None  # raw phred bytes
        name_b = qname.encode() + b"\x00"
        if seq == "*":
            l_seq, packed, qual = 0, b"", b""
        else:
            l_seq = len(seq)
            nib = []
            for c in seq.upper().encode():
                i = _NIB16.find(bytes([c]))
                nib.append(i if i >= 0 else 15)
            if len(nib) % 2:
                nib.append(0)
            packed = bytes(
                (nib[i] << 4) | nib[i + 1] for i in range(0, len(nib), 2)
            )
            qual = raw_qual if raw_qual is not None else b"\xff" * l_seq
            assert len(qual) == l_seq
        cigar = b""
        block = (
            struct.pack(
                "<iiBBHHHiiii", -1, -1, len(name_b), 0, 0, 0, flag,
                l_seq, -1, -1, 0,
            )
            + name_b + cigar + packed + qual
        )
        body.write(struct.pack("<i", len(block)))
        body.write(block)
    raw = body.getvalue()
    if bgzf_chunks <= 1:
        return gzip.compress(raw)
    # split into multiple gzip members to exercise multi-member reads
    step = max(1, len(raw) // bgzf_chunks)
    out = b""
    for i in range(0, len(raw), step):
        out += gzip.compress(raw[i : i + step])
    return out


READS = [
    ("r1", 0, "ACGTACGTACGT"),
    ("r2", 16, "TTTTGGGGCACA"),          # reverse strand
    ("r3", 4, "ACGNNTACGGAT"),           # unmapped, with Ns
    ("sec", 256, "CCCCCCCCCCCC"),        # secondary: skipped
    ("sup", 2048, "GGGGGGGGGGGG"),       # supplementary: skipped
    ("nostar", 0, "*"),                  # no sequence: skipped
    ("r4", 0, "acgtacgGATTACA"),         # lowercase passes through
]

EXPECTED = [
    ("r1", "ACGTACGTACGT"),
    ("r2", revcomp("TTTTGGGGCACA")),
    ("r3", "ACGNNTACGGAT"),
    ("r4", "acgtacgGATTACA"),
]


def test_sam_reader_semantics(tmp_path):
    p = tmp_path / "a.sam"
    p.write_bytes(make_sam(READS))
    with SamReader(str(p)) as r:
        got = [(c.header, c.data.decode()) for c in r.chunks()]
    assert got == EXPECTED


def test_sam_reader_headerless_and_crlf(tmp_path):
    txt = make_sam(READS, header=False).replace(b"\n", b"\r\n")
    p = tmp_path / "h.sam"
    p.write_bytes(txt)
    with SamReader(str(p)) as r:
        got = [(c.header, c.data.decode()) for c in r.chunks()]
    assert got == EXPECTED


def test_bam_reader_matches_sam(tmp_path):
    p = tmp_path / "a.bam"
    p.write_bytes(make_bam(READS))
    with BamReader(str(p)) as r:
        got = [(c.header, c.data.decode()) for c in r.chunks()]
    # BAM stores sequences uppercase (4-bit codes have no case)
    assert got == [(h, s.upper()) for h, s in EXPECTED]


def test_bam_multi_member_gzip(tmp_path):
    p = tmp_path / "m.bam"
    p.write_bytes(make_bam(READS, bgzf_chunks=7))
    with BamReader(str(p)) as r:
        got = [(c.header, c.data.decode()) for c in r.chunks()]
    assert got == [(h, s.upper()) for h, s in EXPECTED]


def test_bam_rejects_non_bam(tmp_path):
    p = tmp_path / "x.bam"
    p.write_bytes(b"not a bam at all")
    with pytest.raises(ValueError, match="magic"):
        BamReader(str(p))


def test_bam_truncated_record(tmp_path):
    full = gzip.decompress(make_bam(READS))
    p = tmp_path / "t.bam"
    p.write_bytes(gzip.compress(full[:-5]))
    with BamReader(str(p)) as r:
        with pytest.raises(ValueError, match="truncated"):
            list(r.chunks())


def test_sniffing(tmp_path):
    sam = tmp_path / "a.sam"
    sam.write_bytes(make_sam(READS))
    assert sniff_format(str(sam)) == "sam"
    hdrless = tmp_path / "h.sam"
    hdrless.write_bytes(make_sam(READS, header=False))
    assert sniff_format(str(hdrless)) == "sam"
    bam = tmp_path / "a.bam"
    bam.write_bytes(make_bam(READS))
    assert sniff_format(str(bam)) == "bam"
    samgz = tmp_path / "a.sam.gz"
    samgz.write_bytes(gzip.compress(make_sam(READS)))
    assert sniff_format(str(samgz)) == "sam"
    # FASTQ '@' lines must still sniff as fastq
    assert sniff_head(b"@read1\nACGT\n+\nIIII\n") == "fastq"
    assert sniff_head(b">rec\nACGT\n") == "fasta"
    assert sniff_head(b"") == "fasta"


def _oracle_fasta(tmp_path, name="reads.fa"):
    """FASTA of the reads the SAM/BAM readers should be equivalent to."""
    fa = tmp_path / name
    fa.write_text(
        "".join(f">{h}\n{s}\n" for h, s in EXPECTED)
    )
    return fa


def test_sam_count_matches_fasta(tmp_path):
    import findkmer_tpu as fk

    sam = tmp_path / "a.sam"
    sam.write_bytes(make_sam(READS))
    fa = _oracle_fasta(tmp_path)
    got = fk.count([str(sam)], k=5).to_dict()
    want = fk.count([str(fa)], k=5).to_dict()
    assert got == want
    assert want  # non-trivial


def test_bam_count_matches_fasta(tmp_path):
    import findkmer_tpu as fk

    bam = tmp_path / "a.bam"
    bam.write_bytes(make_bam(READS))
    fa = _oracle_fasta(tmp_path)
    got = fk.count([str(bam)], k=5).to_dict()
    want = fk.count([str(fa)], k=5).to_dict()
    assert got == want


def test_bam_canonical_count(tmp_path):
    import findkmer_tpu as fk

    bam = tmp_path / "a.bam"
    bam.write_bytes(make_bam(READS))
    fa = _oracle_fasta(tmp_path)
    got = fk.count([str(bam)], k=7, canonical=True).to_dict()
    want = fk.count([str(fa)], k=7, canonical=True).to_dict()
    assert got == want


def _run_cli(args, stdin=None):
    # same env hygiene as every other CLI runner (tests/test_cli.py):
    # the CPU backend and this checkout's package
    env = dict(os.environ)
    env["JAX_PLATFORMS"] = "cpu"
    env["PYTHONPATH"] = str(Path(__file__).resolve().parents[1])
    return subprocess.run(
        [sys.executable, "-m", "findkmer_tpu.cli", *args],
        input=stdin, capture_output=True, timeout=600, env=env,
    )


@pytest.mark.heavy
def test_cli_bam_stdin_and_file(tmp_path):
    """`findkmer count -i reads.bam` == `-i -` (piped) == FASTA run."""
    bam_bytes = make_bam(READS)
    bam = tmp_path / "reads.bam"
    bam.write_bytes(bam_bytes)
    fa = _oracle_fasta(tmp_path)

    r_file = _run_cli(["count", "-i", str(bam), "-k", "4"])
    assert r_file.returncode == 0, r_file.stderr.decode()
    r_pipe = _run_cli(["count", "-i", "-", "-k", "4"], stdin=bam_bytes)
    assert r_pipe.returncode == 0, r_pipe.stderr.decode()
    r_fa = _run_cli(["count", "-i", str(fa), "-k", "4"])
    assert r_fa.returncode == 0, r_fa.stderr.decode()
    assert r_file.stdout == r_fa.stdout
    assert r_pipe.stdout == r_fa.stdout


@pytest.mark.heavy
def test_cli_sam_explicit_format(tmp_path):
    sam = tmp_path / "weird.txt"  # wrong extension: rely on --format
    sam.write_bytes(make_sam(READS))
    fa = _oracle_fasta(tmp_path)
    r = _run_cli(["count", "-i", str(sam), "--format", "sam", "-k", "4"])
    r_fa = _run_cli(["count", "-i", str(fa), "-k", "4"])
    assert r.returncode == 0, r.stderr.decode()
    assert r.stdout == r_fa.stdout


def test_filter_rejects_sam(tmp_path):
    sam = tmp_path / "a.sam"
    sam.write_bytes(make_sam(READS))
    spec = tmp_path / "s.tsv"
    spec.write_text("ACGT\t1\n")
    r = _run_cli(
        ["filter", "-i", str(sam), "--spectrum", str(spec)]
    )
    assert r.returncode != 0
    assert b"FASTA/FASTQ only" in r.stderr
