"""Probe: STORE_ROWS geometry sweep for the k=21 sort slot.

The sparse store's compaction sort is row-wise ((G, C) arrays,
dimension=1).  This sweeps G at fixed totals, at production-shaped
sizes (a chr-scale compaction sorts ~50M slots), to see where the
optimum sits.

Run on the GPU:  python -m bench.probe_rowsort
"""

from __future__ import annotations

import json
import sys
import time

import jax

from bench.steps import setup_jax


def main():
    jax = setup_jax()
    import jax.numpy as jnp
    import numpy as np
    from jax import lax

    dev = jax.devices()[0]


    @jax.jit
    def sort2_rows(a, b):
        return lax.sort((a, b), dimension=1, num_keys=2,
                        is_stable=False)

    from findkmer_tpu.ops import sparse as sparse_ops

    rng = np.random.default_rng(0)
    summary = []
    import os

    gs = tuple(int(g) for g in os.environ.get(
        "FINDKMER_PROBE_G", "32,64,128,256").split(","))
    for n in (3 << 24,):  # 48M (chr-scale compaction shape)
        hi_all = rng.integers(0, 1 << 10, n).astype(np.uint16)
        lo_all = rng.integers(0, 1 << 32, n, dtype=np.uint64).astype(
            np.uint32)
        for G in gs:
            h = jax.device_put(jnp.asarray(hi_all.reshape(G, -1)), dev)
            l = jax.device_put(jnp.asarray(lo_all.reshape(G, -1)), dev)
            out = sort2_rows(h, l)
            jax.block_until_ready(out[0][:1, :1])  # compile + warm
            reps = 3
            t0 = time.perf_counter()
            for _ in range(reps):
                out = sort2_rows(h, l)
            jax.block_until_ready(out[0][:1, :1])
            dt = (time.perf_counter() - t0) / reps
            eps = n / dt
            summary.append((eps, G, n))
            print(json.dumps({
                "probe": f"sort2 u16/u32 rows {G}x{n // G >> 10}K",
                "elem_per_s": eps, "ms": dt * 1e3, "n": n, "G": G,
            }))
            sys.stdout.flush()
            # the FULL first compaction (sort + positional RLE +
            # per-row distinct): what production actually pays —
            # round 2 found the RLE erases the G=128/256 sort win
            out = sparse_ops.compact_raw_2d(h, l)
            jax.block_until_ready(out[3][:1])
            t0 = time.perf_counter()
            for _ in range(reps):
                out = sparse_ops.compact_raw_2d(h, l)
            jax.block_until_ready(out[3][:1])
            dt = (time.perf_counter() - t0) / reps
            print(json.dumps({
                "probe": f"compact_raw_2d u16 {G}x{n // G >> 10}K",
                "elem_per_s": n / dt, "ms": dt * 1e3, "n": n, "G": G,
            }))
            summary.append((n / dt, -G, n))  # -G marks full compaction
            sys.stdout.flush()
    print("# ---- summary (Melem/s) ----", file=sys.stderr)
    for eps, G, n in sorted(summary, reverse=True):
        print(f"#  {eps / 1e6:8.1f}  G={G:<4d} n={n >> 20}M",
              file=sys.stderr)
    return 0


if __name__ == "__main__":
    sys.exit(main())
