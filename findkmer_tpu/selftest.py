"""`findkmer selftest` — deployment sanity check (SURVEY.md §5 metrics/
failure-detection envelope).

Counts synthetic DNA on THIS machine's backend (whatever jax resolves:
GPU, CPU, a mesh with --devices) and diffs the spectra bit-exactly
against a self-contained scalar counter implemented right here — an
independent byte-at-a-time walk, not the engine and not the test
oracle, so a bad install, a miscompiling backend, or a broken native
library shows up as a one-command FAIL before any real data is
touched.  The cases cover the engine's main regimes: dense small-k,
narrow sparse, wide sparse canonical, and a repeat-heavy input that
exercises the count-plane/escape finalize wire.
"""

from __future__ import annotations

import sys
import tempfile
from typing import Dict, Iterable, Tuple

import numpy as np

_COMP = {"A": "T", "C": "G", "G": "C", "T": "A"}


def _scalar_count(seqs: Iterable[str], k: int, canonical: bool
                  ) -> Dict[str, int]:
    """Independent reference: dict-of-strings byte-at-a-time counting
    (uppercase-fold, any non-ACGT byte breaks the window)."""
    counts: Dict[str, int] = {}
    for seq in seqs:
        s = seq.upper()
        n = len(s)
        i = 0
        while i + k <= n:
            w = s[i:i + k]
            if any(c not in _COMP for c in w):
                i += 1
                continue
            if canonical:
                rc = "".join(_COMP[c] for c in reversed(w))
                if rc < w:
                    w = rc
            counts[w] = counts.get(w, 0) + 1
            i += 1
    return counts


def _spectrum_dict(spectrum, k: int) -> Dict[str, int]:
    from findkmer_tpu.output import codes_to_kmer_bytes

    if isinstance(spectrum, tuple):
        codes, counts = spectrum
    else:
        counts = np.asarray(spectrum)
        (codes,) = np.nonzero(counts)
        counts = counts[codes]
    kmers = codes_to_kmer_bytes(np.asarray(codes), k)
    return {
        w.decode(): int(n) for w, n in zip(kmers.tolist(), counts)
    }


def _make_input(rng) -> Tuple[str, list]:
    bases = np.array(list("ACGTacgt"))
    recs = []
    for ln in (4000, 2500):
        arr = bases[rng.integers(0, 8, ln)].astype("U1")
        arr[rng.random(ln) < 0.02] = "N"
        recs.append("".join(arr))
    # repeat-heavy + homopolymer record: drives the count-plane and
    # >255-escape legs of the finalize wire
    rep = recs[0][:900]
    recs.extend([rep] * 3)
    recs.append("A" * 600)
    text = "".join(f">r{i}\n{s}\n" for i, s in enumerate(recs))
    return text, recs


CASES = (
    dict(k=4, canonical=False),    # dense table
    dict(k=13, canonical=False),   # narrow sparse (one u32 plane)
    dict(k=21, canonical=True),    # wide sparse + canonical fold
)


def run(args) -> int:
    """CLI adapter: count each case end-to-end, diff vs the scalar
    reference, print one line per case and a summary; rc 1 on any
    mismatch."""
    import jax

    from findkmer_tpu import pipeline
    from findkmer_tpu.config import Config

    rng = np.random.default_rng(args.seed)
    text, recs = _make_input(rng)
    devices = getattr(args, "devices", 1)
    print(f"backend: {jax.default_backend()} "
          f"({len(jax.local_devices())} local device(s)); "
          f"counting with devices={devices}")
    failures = 0
    with tempfile.NamedTemporaryFile(
        "w", suffix=".fa", delete=False
    ) as f:
        f.write(text)
        path = f.name
    for case in CASES:
        cfg = Config(
            devices=devices, chunk_len=1024,
            batch_rows=max(2, devices), **case
        )
        got = _spectrum_dict(pipeline.count_file(path, cfg), cfg.k)
        want = _scalar_count(recs, cfg.k, cfg.canonical)
        tag = (f"k={cfg.k}"
               + (" canonical" if cfg.canonical else "")
               + f" [{cfg.resolved_table_mode}]")
        if got == want:
            print(f"  PASS {tag}: {len(want)} distinct, "
                  f"{sum(want.values())} total, max count "
                  f"{max(want.values())}")
        else:
            failures += 1
            bad = {w for w in set(want) | set(got)
                   if want.get(w) != got.get(w)}
            sample = [(w, want.get(w), got.get(w))
                      for w in sorted(bad)[:3]]
            print(f"  FAIL {tag}: {len(bad)} mismatches, e.g. "
                  f"{sample}", file=sys.stderr)
    if failures:
        print(f"selftest FAILED ({failures}/{len(CASES)} cases)",
              file=sys.stderr)
        return 1
    print(f"selftest OK ({len(CASES)}/{len(CASES)} cases bit-exact)")
    return 0
