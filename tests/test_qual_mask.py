"""Quality masking (--min-qual): bases below a phred threshold count as N.

Jellyfish --min-qual-char tool class.  Oracle strategy: every test
builds the equivalent FASTA with low-quality bases replaced by 'N'
host-side and requires the identical spectrum.
"""

import gzip
import os
import subprocess
import sys

import numpy as np
import pytest

from conftest import random_dna
from findkmer_tpu.config import Config
from findkmer_tpu.io.fastq import FastqReader, mask_low_quality
from test_sam import make_bam, make_sam
from test_vs_oracle import oracle_dict

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _count(path, k, **cfg_kw):
    from findkmer_tpu import api

    cfg = Config(k=k, chunk_len=64, batch_rows=2, **cfg_kw)
    return api.count([str(path)], k, config=cfg).to_dict()


def _reads_with_quals(rng, n_reads, read_len, min_qual, offset=33):
    """(fastq_text, masked_fasta_text, raw (seq, qual_str) list)."""
    fq, fa, raw = [], [], []
    for i in range(n_reads):
        seq = random_dna(rng, read_len, n_prob=0.02)
        q = rng.integers(0, 42, read_len)
        qual = "".join(chr(offset + int(x)) for x in q)
        masked = "".join(
            "N" if int(x) < min_qual else c for c, x in zip(seq, q)
        )
        fq.append(f"@r{i}\n{seq}\n+\n{qual}\n")
        fa.append(f">r{i}\n{masked}\n")
        raw.append((seq, q))
    return "".join(fq), "".join(fa), raw


def test_mask_low_quality_unit():
    assert mask_low_quality(b"ACGT", b"!I!I", 20) == b"NCNT"
    assert mask_low_quality(b"ACGT", b"IIII", 20) == b"ACGT"  # no copy
    with pytest.raises(ValueError, match="length"):
        mask_low_quality(b"ACGT", b"II", 20)


def test_fastq_min_qual_matches_masked_oracle(rng, tmp_path):
    fq, fa, _ = _reads_with_quals(rng, 30, 60, min_qual=20)
    p = tmp_path / "r.fastq"
    p.write_text(fq)
    got = _count(p, 5, min_qual=20)
    assert got == dict(oracle_dict(fa, 5))
    # and min_qual=0 differs (some low-quality bases exist w.h.p.)
    assert _count(p, 5) != got


def test_fastq_min_qual_custom_offset(rng, tmp_path):
    fq, fa, _ = _reads_with_quals(rng, 10, 50, min_qual=15, offset=64)
    p = tmp_path / "r.fastq"
    p.write_text(fq)
    got = _count(p, 4, min_qual=15, qual_offset=64)
    assert got == dict(oracle_dict(fa, 4))


def test_fastq_min_qual_gzip_reader(rng, tmp_path):
    fq, fa, _ = _reads_with_quals(rng, 8, 40, min_qual=25)
    p = tmp_path / "r.fastq.gz"
    p.write_bytes(gzip.compress(fq.encode()))
    with FastqReader(str(p), min_qual=25) as r:
        recs = list(r.records())
    assert len(recs) == 8
    want = [s.split("\n")[1] for s in fa.strip().split(">")[1:]]
    assert [d.decode() for _, d in recs] == want


def test_fastq_min_qual_truncated_errors(tmp_path):
    p = tmp_path / "t.fastq"
    p.write_text("@r0\nACGTACGT\n+\n")
    with FastqReader(str(p), min_qual=10) as r:
        with pytest.raises(ValueError, match="quality line"):
            list(r.records())
    p.write_text("@r0\nACGTACGT\n+\nIIII\n")  # qual shorter than seq
    with FastqReader(str(p), min_qual=10) as r:
        with pytest.raises(ValueError, match="length"):
            list(r.records())


def test_sam_min_qual_and_reverse_strand(rng, tmp_path):
    # qual is stored in alignment orientation like SEQ: a reverse-strand
    # record must mask positionally BEFORE re-orientation
    seq = "ACGTACGTAAGG"
    qual = "I!" * 6  # every odd stored position is low quality
    sam = make_sam([("f", 0, seq, qual), ("r", 16, seq, qual)])
    p = tmp_path / "r.sam"
    p.write_bytes(sam)
    got = _count(p, 3, min_qual=20, input_format="sam")
    from test_sam import revcomp

    fwd = "".join(
        "N" if qual[i] == "!" else c for i, c in enumerate(seq)
    )
    fa = f">f\n{fwd}\n>r\n{revcomp(fwd)}\n"
    assert got == dict(oracle_dict(fa, 3))


def test_bam_min_qual_raw_phred(rng, tmp_path):
    seq = "ACGTACGTACGTACGT"
    q = bytes([5 if i % 3 == 0 else 30 for i in range(len(seq))])
    p = tmp_path / "r.bam"
    p.write_bytes(make_bam([("a", 0, seq, q)]))
    got = _count(p, 4, min_qual=20, input_format="bam")
    masked = "".join(
        "N" if q[i] < 20 else c for i, c in enumerate(seq)
    )
    assert got == dict(oracle_dict(f">a\n{masked}\n", 4))
    # absent qualities (0xff fill) pass unmasked
    p.write_bytes(make_bam([("a", 0, seq)]))
    assert _count(p, 4, min_qual=20, input_format="bam") == dict(
        oracle_dict(f">a\n{seq}\n", 4)
    )


def test_min_qual_rejects_fasta(tmp_path):
    with pytest.raises(ValueError, match="min_qual"):
        Config(k=4, min_qual=10, input_format="fasta")
    p = tmp_path / "x.fa"
    p.write_text(">a\nACGTACGT\n")
    with pytest.raises(ValueError, match="FASTA"):
        _count(p, 4, min_qual=10)  # sniffed fasta under auto


@pytest.mark.heavy
def test_cli_min_qual(rng, tmp_path):
    fq, fa, _ = _reads_with_quals(rng, 12, 48, min_qual=20)
    (tmp_path / "r.fastq").write_text(fq)
    env = dict(os.environ)
    env["JAX_PLATFORMS"] = "cpu"
    env["PYTHONPATH"] = REPO
    r = subprocess.run(
        [sys.executable, "-m", "findkmer_tpu.cli", "count",
         "-i", "r.fastq", "-k", "5", "--min-qual", "20"],
        capture_output=True, text=True, env=env, cwd=str(tmp_path),
        timeout=300,
    )
    assert r.returncode == 0, r.stderr
    want = dict(oracle_dict(fa, 5))
    got = {}
    for line in r.stdout.splitlines():
        kmer, cnt = line.split("\t")
        got[kmer] = int(cnt)
    assert got == want
