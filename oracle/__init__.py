"""Scalar oracle package: the stand-in correctness reference for findkmer-tpu.

The upstream reference (soundude462/findKmer) was unavailable at build time
(see SURVEY.md §0: /root/reference is an empty mount), so this package provides
a deliberately naive, obviously-correct byte-at-a-time k-mer counter that
mirrors the reference's documented semantics (SURVEY.md §0.1).  Every device
code path in findkmer_tpu is proven bit-exact against this oracle.
"""

from oracle.scalar import (
    count_kmers_in_text,
    count_kmers_in_records,
    count_fasta_file,
    revcomp_str,
    canonical_str,
    spectrum_lines,
)

__all__ = [
    "count_kmers_in_text",
    "count_kmers_in_records",
    "count_fasta_file",
    "revcomp_str",
    "canonical_str",
    "spectrum_lines",
]
