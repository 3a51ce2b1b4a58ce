"""Probe: device filter engine vs the host C scan.

Measures hits_batch (the scorer alone, what the engines differ in) and
filter_file end-to-end on synthetic 100 bp reads against a chr-scale-
shaped k=21 spectrum.

Run:  python -m bench.probe_filter [--reads N] [--k K]
"""

from __future__ import annotations

import argparse
import json
import sys
import time

import numpy as np

from bench.steps import setup_jax


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--reads", type=int, default=500_000)
    ap.add_argument("--read-len", type=int, default=100)
    ap.add_argument("--genome", type=int, default=4_000_000,
                    help="source genome bases (spectrum = its distinct "
                         "k-mers; half the reads sample it -> ~50% hit "
                         "reads, the contamination-filter profile)")
    ap.add_argument("--k", type=int, default=21)
    args = ap.parse_args()

    jax = setup_jax()

    from findkmer_tpu.filter import FilterSpec, window_codes_host
    from findkmer_tpu.filter_device import DeviceFilter

    k = args.k
    rng = np.random.default_rng(0)
    bases = np.frombuffer(b"ACGT", np.uint8)
    genome = bases[rng.integers(0, 4, args.genome)].tobytes()
    gcodes, gvalid = window_codes_host(genome, k)
    codes = np.unique(gcodes[gvalid])
    spec = FilterSpec(k=k, codes=codes)

    # reads: half sampled from the genome (hit-heavy), half random
    reads = []
    L = args.read_len
    for i in range(args.reads):
        if i % 2 == 0:
            p = int(rng.integers(0, args.genome - L))
            reads.append(genome[p : p + L])
        else:
            reads.append(bases[rng.integers(0, 4, L)].tobytes())
    total_bases = args.reads * L
    del genome, gcodes, gvalid

    dev = DeviceFilter(spec)

    def timed(scorer):
        """Cold + warm wall time: the first call pays jit compiles AND
        fresh-page faults on every working buffer; production streams reuse same-size
        buffers per flush (utils/malloc_tuning keeps freed ones), so
        the WARM run is the steady-state number."""
        t0 = time.perf_counter()
        h, w = scorer.hits_batch(reads)
        cold = time.perf_counter() - t0
        t0 = time.perf_counter()
        h, w = scorer.hits_batch(reads)
        warm = time.perf_counter() - t0
        return cold, warm, h, w

    # step-only at production geometry, inputs pre-staged on the device
    # — the same accounting as the counting bench (bench/steps.py)
    import jax.numpy as jnp

    from findkmer_tpu.filter_device import _filter_step
    from findkmer_tpu.io import native as native_mod
    from findkmer_tpu.pipeline import _numpy_pack_rows

    work = np.full(k - 1 + dev.need, 4, np.uint8)
    work[k - 1:] = rng.integers(0, 4, dev.need, dtype=np.uint8)
    if native_mod.available():
        packed, validbits = native_mod.pack_rows(work, dev.B, dev.L,
                                                 dev.R)
    else:
        packed, validbits = _numpy_pack_rows(work, dev.B, dev.L, dev.R,
                                             dev.R8)
    dp = jax.device_put(jnp.asarray(packed), dev._dev)
    dv = jax.device_put(jnp.asarray(validbits), dev._dev)
    bm = _filter_step(dev.members, dp, dv, k, False, dev.R, dev.L)
    jax.block_until_ready(bm[:1])
    t0 = time.perf_counter()
    for _ in range(3):
        bm = _filter_step(dev.members, dp, dv, k, False, dev.R, dev.L)
    jax.block_until_ready(bm[:1])
    dt = (time.perf_counter() - t0) / 3
    print(json.dumps({
        "probe": f"filter_device_step_k{k}",
        "bases_per_s": dev.need / dt,
        "reads_per_s_equiv": dev.need / args.read_len / dt,
        "wall_s": dt,
        "spectrum": int(codes.size),
    }))
    sys.stdout.flush()

    cold_d, warm_d, hd, wd = timed(dev)
    cold_h, warm_h, hh, wh = timed(spec)
    assert (hd == hh).all() and (wd == wh).all(), "engine mismatch!"
    for name, cold, warm in (("device", cold_d, warm_d),
                             ("host", cold_h, warm_h)):
        print(json.dumps({
            "probe": f"filter_{name}_k{k}",
            "reads_per_s": args.reads / warm,
            "bases_per_s": total_bases / warm,
            "wall_s": warm,
            "cold_wall_s": cold,
            "spectrum": int(codes.size),
        }))
        sys.stdout.flush()
    print(json.dumps({
        "probe": "filter_speedup_device_over_host",
        "value": warm_h / warm_d,
    }))
    sys.stdout.flush()

    # TRUE end-to-end through filter_file: FASTQ parse -> flush batches
    # -> device begin/finish pipeline (FINDKMER_FILTER_DEPTH) -> output
    # write.  This is what `findkmer filter --engine device` pays.
    import os
    import tempfile

    from findkmer_tpu.filter import filter_file

    with tempfile.TemporaryDirectory() as td:
        fq = os.path.join(td, "r.fastq")
        with open(fq, "wb") as f:
            qual = b"I" * L
            for i, r in enumerate(reads):
                f.write(b"@r%d\n%s\n+\n%s\n" % (i, r, qual))
        devnull = open(os.devnull, "wb")
        first = True
        for depth in ("0", "2"):
            os.environ["FINDKMER_FILTER_DEPTH"] = depth
            reps = ("cold", "warm") if first else ("warm",)
            first = False
            for rep in reps:
                t0 = time.perf_counter()
                kept, seen = filter_file(fq, devnull, spec, fmt="fastq",
                                         engine="device")
                dt = time.perf_counter() - t0
                print(json.dumps({
                    "probe": f"filter_file_device_k{k}_{rep}",
                    "depth": depth,
                    "reads_per_s": seen / dt,
                    "bases_per_s": total_bases / dt,
                    "wall_s": dt,
                    "kept": kept,
                }))
                sys.stdout.flush()
        devnull.close()
    return 0


if __name__ == "__main__":
    sys.exit(main())
