"""Probe: sweep the store row-count G of the full compaction chain.

Sweeps the FULL compaction chain (sort + RLE: compact_raw_2d, and the
store-carrying compact_counted_2d) at G up to 65536, at chr-scale-shaped
totals, to find the knee (ops/compaction.row_geometry's g_cap; ROADMAP
S3/D5).

Run on the GPU: python -m bench.probe_rowsort2
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


    from findkmer_tpu.ops import sparse as sparse_ops

    rng = np.random.default_rng(0)
    N = 4096 * 24576          # ~100M slots, one chr-scale compaction

    hi = rng.integers(0, 1 << 10, N, dtype=np.uint16)
    lo = rng.integers(0, 1 << 32, N, dtype=np.uint32)

    def timed(name, fn, args, reps=3):
        out = fn(*args)
        jax.block_until_ready(out[0][:1, :4096])
        t0 = time.perf_counter()
        for _ in range(reps):
            out = fn(*args)
        jax.block_until_ready(out[0][:1, :4096])
        dt = (time.perf_counter() - t0) / reps
        print(json.dumps({
            "probe": name, "ms": round(dt * 1e3, 1),
            "melem_s": round(N / dt / 1e6, 1),
            "ns_per_elem": round(dt / N * 1e9, 3),
        }))
        sys.stdout.flush()

    import os

    gs = tuple(int(v) for v in os.environ.get(
        "FINDKMER_PROBE_GS", "4096,8192,16384,32768,65536"
    ).split(","))
    for g in gs:
        d_hi = jax.device_put(jnp.asarray(hi.reshape(g, -1)))
        d_lo = jax.device_put(jnp.asarray(lo.reshape(g, -1)))
        timed(f"compact_raw_g{g}", sparse_ops.compact_raw_2d,
              (d_hi, d_lo))
        # store-carrying variant: same shapes plus an i32 count plane
        d_cnt = jax.device_put(
            jnp.ones((g, N // g), jnp.int32)
        )
        timed(f"compact_counted_g{g}", sparse_ops.compact_counted_2d,
              (d_hi, d_lo, d_cnt))
        del d_hi, d_lo, d_cnt


if __name__ == "__main__":
    main()
