"""Naive scalar k-mer counting oracle.

This is the correctness bar for the whole framework (SURVEY.md §0.3): a
byte-at-a-time pure-Python counter that mirrors the reference findKmer's
semantics as distilled into the behavior contract (SURVEY.md §0.1):

  * DNA over {A,C,G,T}, case-insensitive.
  * Every length-k window of each record is counted, stride 1, overlapping.
  * Any non-ACGT byte (N, IUPAC codes, anything else) resets the rolling
    window: no window containing such a byte is counted.
  * Windows never span a FASTA record boundary.
  * Counts are exact integers.
  * Optional canonical mode counts min(kmer, revcomp(kmer)) instead.

Deliberately slow and simple — no bit tricks, no vectorization — so that it
is obviously correct by inspection.  The engine is diffed against this
on every test (tests/test_vs_oracle.py).

Reference parity note: the upstream reference (soundude462/findKmer) could
not be cited file:line because its mount was empty at build time
(SURVEY.md §0).  This oracle encodes the contract the reference is
documented (BASELINE.json) to implement: the byte-at-a-time scanner with
N-base window reset corresponds to the reference's C scan loop
(SURVEY.md §3.1 E2), and the ordered spectrum emission corresponds to its
output traversal (SURVEY.md §3.1 E4).
"""

from __future__ import annotations

from typing import Dict, Iterable, List, Tuple

_BASES = "ACGT"
_COMP = {"A": "T", "C": "G", "G": "C", "T": "A"}


def revcomp_str(kmer: str) -> str:
    """Reverse complement of an uppercase ACGT string."""
    return "".join(_COMP[c] for c in reversed(kmer))


def canonical_str(kmer: str) -> str:
    """min(kmer, revcomp(kmer)) under lexicographic (== 2-bit code) order."""
    rc = revcomp_str(kmer)
    return kmer if kmer <= rc else rc


def count_kmers_in_text(
    seq: str, k: int, *, canonical: bool = False, counts: Dict[str, int] | None = None
) -> Dict[str, int]:
    """Count k-mers in a single sequence (one FASTA record's bases).

    Byte-at-a-time: walk the sequence, keep a window of the last `run` valid
    bases; any non-ACGT byte resets the run (SURVEY.md §3.1 E2).
    """
    if k <= 0:
        raise ValueError(f"k must be positive, got {k}")
    if counts is None:
        counts = {}
    run: List[str] = []  # last (< k) valid uppercase bases
    for ch in seq:
        c = ch.upper()
        if c in _BASES:
            run.append(c)
            if len(run) >= k:
                kmer = "".join(run[-k:])
                if canonical:
                    kmer = canonical_str(kmer)
                counts[kmer] = counts.get(kmer, 0) + 1
                # keep only what the next window needs
                if len(run) > k:
                    del run[0 : len(run) - k]
        else:
            run.clear()  # window reset: N / IUPAC / anything else
    return counts


def count_kmers_in_records(
    records: Iterable[str], k: int, *, canonical: bool = False
) -> Dict[str, int]:
    """Count k-mers across records; windows never cross record boundaries."""
    counts: Dict[str, int] = {}
    for seq in records:
        count_kmers_in_text(seq, k, canonical=canonical, counts=counts)
    return counts


def parse_fasta_text(text: str) -> List[Tuple[str, str]]:
    """Parse FASTA text into (header, sequence) pairs.

    Headers are lines starting with '>'.  Leading sequence data before any
    header becomes a record with an empty header (matches lenient scanners
    that treat a headerless file as one sequence, SURVEY.md §3.1 E2 note).
    """
    records: List[Tuple[str, str]] = []
    header: str | None = None
    chunks: List[str] = []
    started = False
    for line in text.splitlines():
        if line.startswith(">"):
            if started:
                records.append((header or "", "".join(chunks)))
            header = line[1:].strip()
            chunks = []
            started = True
        else:
            s = line.strip()
            if s:
                if not started:
                    started = True
                    header = ""
                chunks.append(s)
    if started:
        records.append((header or "", "".join(chunks)))
    return records


def count_fasta_file(
    path: str, k: int, *, canonical: bool = False
) -> Dict[str, int]:
    """Count k-mers in a FASTA file on disk."""
    with open(path, "r") as f:
        text = f.read()
    return count_kmers_in_records(
        (seq for _, seq in parse_fasta_text(text)), k, canonical=canonical
    )


def all_kmers(k: int) -> Iterable[str]:
    """All 4^k k-mers in lexicographic (2-bit code) order.  Only for small k."""
    if k == 0:
        yield ""
        return
    for prefix in all_kmers(k - 1):
        for b in _BASES:
            yield prefix + b


def canonical_kmers(k: int) -> Iterable[str]:
    """All canonical k-mers (kmer <= revcomp(kmer)) in lexicographic
    order — the zero-interleave code space of a canonical spectrum."""
    for kmer in all_kmers(k):
        if kmer <= revcomp_str(kmer):
            yield kmer


def spectrum_lines(
    counts: Dict[str, int],
    k: int,
    *,
    zeros: bool = False,
    sep: str = "\t",
    canonical: bool = False,
) -> List[str]:
    """Render the spectrum as `KMER<sep>COUNT` lines in lexicographic order.

    With zeros=True every one of the 4^k k-mers is emitted (only sensible for
    small k); canonical=True restricts the zero interleave to the canonical
    (kmer <= revcomp) code space — the enumerable space of a canonical
    spectrum.  Otherwise only observed k-mers, still ordered.
    Mirrors the reference's ordered output traversal (SURVEY.md §3.1 E4).
    """
    if zeros:
        enum = canonical_kmers if canonical else all_kmers
        return [f"{kmer}{sep}{counts.get(kmer, 0)}" for kmer in enum(k)]
    return [f"{kmer}{sep}{counts[kmer]}" for kmer in sorted(counts)]
