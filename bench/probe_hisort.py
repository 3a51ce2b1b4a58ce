"""Probe: does a narrower hi plane make the k=21 sort cheaper?

A k in [16, 23] has hi = 2k-32 <= 14 bits, so the hi plane fits uint16
(sentinel 0xFFFF stays distinguishable through k=23: real hi <= 2^14-1),
and (hi u16, lo u32) moves 6 B/elem instead of 8.  This probe measures
whether XLA's sort delivers that byte scaling for 16-bit keys (it may
pad sub-32-bit operands).

Run on the GPU:  python -m bench.probe_hisort [--x64]
Prints one JSON line per probe; summary table to stderr.
"""

from __future__ import annotations

import argparse
import json
import sys
import time

import jax

from bench.steps import setup_jax


def _time(fn, args, reps, sync_arr_of):
    out = fn(*args)
    jax.block_until_ready(sync_arr_of(out))  # compile + warm
    t0 = time.perf_counter()
    for _ in range(reps):
        out = fn(*args)
    jax.block_until_ready(sync_arr_of(out))
    return (time.perf_counter() - t0) / reps


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--x64", action="store_true",
                    help="also probe single-array uint64 sort")
    ap.add_argument("--reps", type=int, default=3)
    args = ap.parse_args()

    jax = setup_jax()
    if args.x64:
        jax.config.update("jax_enable_x64", True)
    import jax.numpy as jnp
    import numpy as np
    from jax import lax

    rng = np.random.default_rng(0)
    reps = args.reps
    results = {}

    def report(name, dt, n):
        results[name] = n / dt
        print(json.dumps({"probe": name, "elem_per_s": n / dt,
                          "ms": dt * 1e3, "n": n}))
        sys.stdout.flush()

    @jax.jit
    def sort2(a, b):
        return lax.sort((a, b), num_keys=2, is_stable=False)

    @jax.jit
    def sort3(a, b, c):
        return lax.sort((a, b, c), num_keys=2, is_stable=False)

    @jax.jit
    def sort1(a):
        return lax.sort((a,), num_keys=1, is_stable=False)[0]

    @jax.jit
    def sort2_rows(a, b):
        return lax.sort((a, b), dimension=1, num_keys=2, is_stable=False)

    for n in (1 << 23, 1 << 24, 1 << 25):
        hi16_np = rng.integers(0, 1 << 10, n, dtype=np.uint16)
        lo_np = rng.integers(0, 1 << 32, n, dtype=np.uint32)
        hi16 = jax.device_put(jnp.asarray(hi16_np))
        hi32 = jax.device_put(jnp.asarray(hi16_np.astype(np.uint32)))
        lo = jax.device_put(jnp.asarray(lo_np))
        cnt = jax.device_put(jnp.ones((n,), jnp.int32))
        M = n >> 20

        report(f"sort2 u16/u32 n={M}M",
               _time(sort2, (hi16, lo), reps, lambda o: o[0][:1]), n)
        report(f"sort2 u32/u32 n={M}M",
               _time(sort2, (hi32, lo), reps, lambda o: o[0][:1]), n)
        if n == 1 << 24:
            report(f"sort1 u32 n={M}M",
                   _time(sort1, (lo,), reps, lambda o: o[:1]), n)
            report(f"sort3 u16/u32/i32 n={M}M",
                   _time(sort3, (hi16, lo, cnt), reps,
                         lambda o: o[0][:1]), n)
            report(f"sort3 u32/u32/i32 n={M}M",
                   _time(sort3, (hi32, lo, cnt), reps,
                         lambda o: o[0][:1]), n)
            # row-wise (the production compaction shape, 64 rows)
            G = 64
            h2, l2 = hi16.reshape(G, -1), lo.reshape(G, -1)
            report(f"sort2 u16/u32 rows {G}x{n // G >> 10}K",
                   _time(sort2_rows, (h2, l2), reps,
                         lambda o: o[0][0, :1]), n)
            h2w = hi32.reshape(G, -1)
            report(f"sort2 u32/u32 rows {G}x{n // G >> 10}K",
                   _time(sort2_rows, (h2w, l2), reps,
                         lambda o: o[0][0, :1]), n)
            if args.x64:
                k64 = jax.device_put(jnp.asarray(
                    (hi16_np.astype(np.uint64) << np.uint64(32))
                    | lo_np.astype(np.uint64)))
                report(f"sort1 u64 n={M}M",
                       _time(sort1, (k64,), reps, lambda o: o[:1]), n)

        # correctness: u16-key 2-key sort must match numpy on packed key
        if n == 1 << 23:
            sh, sl = sort2(hi16, lo)
            got = (np.asarray(sh).astype(np.uint64) << np.uint64(32)) | \
                np.asarray(sl).astype(np.uint64)
            want = np.sort((hi16_np.astype(np.uint64) << np.uint64(32))
                           | lo_np.astype(np.uint64))
            assert (got == want).all(), "u16-key sort INCORRECT"
            print("# sort2 u16/u32 correct vs numpy", file=sys.stderr)

    print("# ---- summary (Melem/s) ----", file=sys.stderr)
    for k, v in sorted(results.items(), key=lambda kv: -kv[1]):
        print(f"# {v / 1e6:9.1f}  {k}", file=sys.stderr)
    return 0


if __name__ == "__main__":
    sys.exit(main())
