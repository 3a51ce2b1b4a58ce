"""Probe: gather vs segmented-scan rle_val.

The store-carrying compaction (compact_counted_2d) differs from the raw
one structurally only in rle_val's run-total propagation (plus the 3rd
sort operand).  ops/sparse.seg_totals computes it with a hand-unrolled
Hillis-Steele affine scan (log2(C) shift levels) instead of a
take_along_axis gather.  This probe times, at ~100M slots:

  sort3op          sort (hi, lo, cnt) num_keys=2 alone (the floor)
  counted_scan     production compact_counted_2d (scan rle_val)
  counted_gather   the gather formulation, inlined
  global_scan      global_compact_wide (flat, 27 scan levels)

Run on the GPU: python -m bench.probe_rle
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
    import jax.numpy as jnp
    from jax import lax


    from findkmer_tpu.ops import sparse as sparse_ops

    rng = np.random.default_rng(0)
    G, C = 16384, 6144
    N = G * C

    hi = rng.integers(0, 1 << 10, (G, C), dtype=np.uint16)
    lo = rng.integers(0, 1 << 32, (G, C), dtype=np.uint32)
    d_hi = jax.device_put(jnp.asarray(hi))
    d_lo = jax.device_put(jnp.asarray(lo))
    d_cnt = jax.device_put(jnp.ones((G, C), jnp.int32))

    def timed(name, fn, args, reps=3):
        out = fn(*args)
        jax.block_until_ready(out[0][:1, :4096] if out[0].ndim == 2 else out[0][:4096])
        t0 = time.perf_counter()
        for _ in range(reps):
            out = fn(*args)
        jax.block_until_ready(out[0][:1, :4096] if out[0].ndim == 2 else out[0][:4096])
        dt = (time.perf_counter() - t0) / reps
        print(json.dumps({
            "probe": name, "ms": round(dt * 1e3, 1),
            "melem_s": round(N / dt / 1e6, 1),
            "ns_per_elem": round(dt / N * 1e9, 3),
        }))
        sys.stdout.flush()
        return out

    @jax.jit
    def sort3op(a, b, c):
        return lax.sort((a, b, c), dimension=1, num_keys=2,
                        is_stable=False)

    def _rle_val_2d_gather(hi, lo, cnt, wide=True):
        is_start, is_end = sparse_ops._adj_flags_2d(hi, lo)
        udt = jnp.uint64 if cnt.dtype == jnp.int64 else jnp.uint32
        cu = cnt.astype(udt)
        Cc = jnp.cumsum(cu, axis=1)
        idx = lax.broadcasted_iota(jnp.int32, hi.shape, 1)
        spos = lax.cummax(jnp.where(is_start, idx, 0), axis=1)
        base = jnp.take_along_axis(Cc - cu, spos, axis=1)
        return jnp.where(
            is_end & ~sparse_ops._is_sent(hi, lo, wide), Cc - base, 0
        ).astype(cnt.dtype)

    @jax.jit
    def counted_gather(a, b, c):
        a, b, c = lax.sort((a, b, c), dimension=1, num_keys=2,
                           is_stable=False)
        c = _rle_val_2d_gather(a, b, c)
        return a, b, c, jnp.count_nonzero(c, axis=1)

    timed("sort3op_16384x6144", sort3op, (d_hi, d_lo, d_cnt))
    timed("counted_scan", sparse_ops.compact_counted_2d,
          (d_hi, d_lo, d_cnt))
    timed("counted_gather", counted_gather, (d_hi, d_lo, d_cnt))

    del d_cnt
    d_cnt1 = jax.device_put(jnp.ones((G, C), jnp.int32))
    timed("global_scan_flat100M",
          sparse_ops.global_compact_wide, (d_hi, d_lo, d_cnt1))


if __name__ == "__main__":
    main()
