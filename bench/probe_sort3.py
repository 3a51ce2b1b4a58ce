"""Probe: can the k=21 compaction SORT get cheaper?

Measures, at production row geometry (G=4096, chr-scale-shaped totals),
what the sort costs under different key layouts (ROADMAP S3):

  sort2_u16u32   current production: 2-key (u16 hi, u32 lo)   6 B/elem
  sort1_u32      single-key u32 (comparator floor, 4 B)
  sort1_u16      single-key u16 (byte floor, 2 B)
  sort1_u64      single-key u64 under x64 (1 compare, 8 B)
  pack_sort_u64  (hi,lo) -> pack u64 in-jit -> 1-key sort -> unpack
                 (what landing u64 would actually run)
  g_sweep        2-key sort at G = 4096 / 8192 / 16384, same total

Run on the GPU: python -m bench.probe_sort3
"""

from __future__ import annotations

import json
import sys
import time

import numpy as np

import jax

from bench.steps import setup_jax


def main():
    jax = setup_jax()
    jax.config.update("jax_enable_x64", True)
    import jax.numpy as jnp
    from jax import lax


    rng = np.random.default_rng(0)
    G, C = 4096, 24576            # ~100M slots: one chr-scale compaction
    N = G * C

    hi = rng.integers(0, 1 << 10, (G, C), dtype=np.uint16)
    lo = rng.integers(0, 1 << 32, (G, C), dtype=np.uint32)
    d_hi = jax.device_put(jnp.asarray(hi))
    d_lo = jax.device_put(jnp.asarray(lo))

    def timed(name, fn, args, reps=3, n=N):
        out = fn(*args)
        jax.block_until_ready(out[0][:1, :4096] if out[0].ndim == 2 else out[0][:4096])
        t0 = time.perf_counter()
        for _ in range(reps):
            out = fn(*args)
        jax.block_until_ready(out[0][:1, :4096] if out[0].ndim == 2 else out[0][:4096])
        dt = (time.perf_counter() - t0) / reps
        print(json.dumps({
            "probe": name, "ms": round(dt * 1e3, 1),
            "melem_s": round(n / dt / 1e6, 1),
            "ns_per_elem": round(dt / n * 1e9, 3),
        }))
        sys.stdout.flush()
        return out

    import functools

    @jax.jit
    def sort2(a, b):
        return lax.sort((a, b), dimension=1, num_keys=2, is_stable=False)

    @jax.jit
    def sort1(a):
        return (lax.sort(a, dimension=1, is_stable=False),)

    @jax.jit
    def pack_sort_u64(a, b):
        w = (a.astype(jnp.uint64) << 32) | b.astype(jnp.uint64)
        w = lax.sort(w, dimension=1, is_stable=False)
        return (w >> 32).astype(jnp.uint16), w.astype(jnp.uint32)

    timed("sort2_u16u32_4096x24K", sort2, (d_hi, d_lo))
    timed("sort1_u32", sort1, (d_lo,))
    timed("sort1_u16", sort1, (d_hi,))

    w64 = jax.device_put(
        jnp.asarray((hi.astype(np.uint64) << 32) | lo.astype(np.uint64))
    )
    timed("sort1_u64", sort1, (w64,))
    del w64
    timed("pack_sort_u64", pack_sort_u64, (d_hi, d_lo))

    # production full chain for the same shape, as the reference point
    from findkmer_tpu.ops import sparse as sparse_ops

    @jax.jit
    def full2(a, b):
        return sparse_ops.compact_raw_2d(a, b)

    timed("full_compact_2key", full2, (d_hi, d_lo))

    # geometry re-check on this window (same total, 2-key)
    for g2 in (8192, 16384):
        h2 = jax.device_put(jnp.asarray(hi.reshape(g2, -1)))
        l2 = jax.device_put(jnp.asarray(lo.reshape(g2, -1)))
        timed(f"sort2_g{g2}", sort2, (h2, l2))
        del h2, l2


if __name__ == "__main__":
    main()
