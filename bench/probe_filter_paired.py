"""Probe: paired-end offsets flow vs the list-based flow.

Measures the throughput of _filter_fastq_offsets_paired (byte-identity
covered by tests/test_filter.py::test_filter_paired_fast_flow_byte_identical)
against the list-based flow.  Host engine, CPU only (the host C scan is
the `auto` engine pick when built).

Run:  python -m bench.probe_filter_paired [--pairs N]
"""

from __future__ import annotations

import argparse
import io
import json
import os
import time

import numpy as np

os.environ.setdefault("JAX_PLATFORMS", "cpu")


def make_fastq(path, rng, n_reads, L):
    qual = b"I" * L
    bases = np.frombuffer(b"ACGT", np.uint8)
    seqs = bases[rng.integers(0, 4, (n_reads, L))]
    with open(path, "wb") as f:
        for i in range(n_reads):
            f.write(b"@r%d\n%s\n+\n%s\n" % (i, seqs[i].tobytes(), qual))


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--pairs", type=int, default=167_000)
    ap.add_argument("--read-len", type=int, default=150)
    ap.add_argument("--genome", type=int, default=1_000_000,
                    help="spectrum source bases (~distinct entries; the "
                         "round-4 single-end numbers used a 1M-entry "
                         "spectrum — bigger tables shift both flows "
                         "into the C scan and compress the ratio)")
    ap.add_argument("--k", type=int, default=21)
    args = ap.parse_args()

    from findkmer_tpu import filter as filter_mod
    from findkmer_tpu.filter import FilterSpec, window_codes_host

    rng = np.random.default_rng(0)
    bases = np.frombuffer(b"ACGT", np.uint8)
    genome = bases[rng.integers(0, 4, args.genome)].tobytes()
    gcodes, gvalid = window_codes_host(genome, args.k)
    spec = FilterSpec(k=args.k, codes=np.unique(gcodes[gvalid]))

    r1, r2 = "/tmp/pp_R1.fastq", "/tmp/pp_R2.fastq"
    make_fastq(r1, rng, args.pairs, args.read_len)
    make_fastq(r2, rng, args.pairs, args.read_len)

    def run(fast):
        os.environ["FINDKMER_FILTER_FAST"] = "1" if fast else "0"
        o1, o2 = io.BytesIO(), io.BytesIO()
        t0 = time.perf_counter()
        kept, seen = filter_mod.filter_file_paired(
            r1, r2, o1, o2, spec, engine="host", min_hits=1,
        )
        dt = time.perf_counter() - t0
        return kept, seen, dt, o1.getvalue(), o2.getvalue()

    # warm both paths once on a small prefix? (host-only: skip, pages
    # are warmed by the generation pass)
    k1, s1, t_fast, a1, a2 = run(True)
    k2, s2, t_list, b1, b2 = run(False)
    assert (k1, s1) == (k2, s2) and a1 == b1 and a2 == b2, "flows differ!"
    out = {
        "probe": "filter_paired_keepfew",
        "pairs": s1,
        "kept": k1,
        "offsets_kpairs_s": round(s1 / t_fast / 1e3, 1),
        "list_kpairs_s": round(s1 / t_list / 1e3, 1),
        "speedup": round(t_list / t_fast, 2),
    }
    print(json.dumps(out))


if __name__ == "__main__":
    main()
