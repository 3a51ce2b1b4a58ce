"""Primitive probes for the sparse-path design.

Measures, on the device, the building blocks a sorted-run (LSM)
sparse store can be made of, so the design follows measurement:

  * lax.sort in every relevant configuration (key count, payload count,
    stability, batched independent rows)
  * hand-built bitonic MERGE of two sorted runs (log N compare-exchange
    passes — one log factor cheaper than a full bitonic sort)
  * the RLE dedup scan (cumsum + cummax + gather)
  * XLA scatter set/add at route-buffer and count-table shapes
  * gather (take) throughput

Run:  python -m bench.probe_sort [--quick]
Prints one JSON line per probe to stdout; summary table to stderr.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from functools import partial

import jax

from bench.steps import setup_jax


def _time(fn, args, reps, sync_arr_of):
    """Wall time of reps calls of jitted fn; serialize on D2H reduction."""
    out = fn(*args)
    jax.block_until_ready(sync_arr_of(out))  # compile + warm
    t0 = time.perf_counter()
    for _ in range(reps):
        out = fn(*args)
    jax.block_until_ready(sync_arr_of(out))
    return (time.perf_counter() - t0) / reps


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--quick", action="store_true")
    ap.add_argument("--n", type=int, default=1 << 23)  # 8M
    args = ap.parse_args()

    jax = setup_jax()
    import jax.numpy as jnp
    import numpy as np
    from jax import lax

    N = args.n
    reps = 2 if args.quick else 4
    rng = np.random.default_rng(0)
    dev = jax.devices()[0]
    print(f"# device: {dev}", file=sys.stderr)

    hi_np = rng.integers(0, 1 << 10, N, dtype=np.uint32)
    lo_np = rng.integers(0, 1 << 32, N, dtype=np.uint32)
    hi = jax.device_put(jnp.asarray(hi_np))
    lo = jax.device_put(jnp.asarray(lo_np))
    cnt = jax.device_put(jnp.ones((N,), jnp.int32))

    results = {}

    def report(name, dt, n=N):
        results[name] = n / dt
        print(json.dumps({"probe": name, "elem_per_s": n / dt,
                          "ms": dt * 1e3, "n": n}))
        sys.stdout.flush()

    # ---------------- lax.sort variants ----------------
    @jax.jit
    def sort1(x):
        return lax.sort((x,), num_keys=1, is_stable=False)[0]

    @jax.jit
    def sort1_stable(x):
        return lax.sort((x,), num_keys=1, is_stable=True)[0]

    @jax.jit
    def sort1p(x, p):
        return lax.sort((x, p), num_keys=1, is_stable=False)

    @jax.jit
    def sort2(a, b):
        return lax.sort((a, b), num_keys=2, is_stable=False)

    @jax.jit
    def sort2p(a, b, c):
        return lax.sort((a, b, c), num_keys=2, is_stable=False)

    @jax.jit
    def sort2p_stable(a, b, c):
        return lax.sort((a, b, c), num_keys=2, is_stable=True)

    report("sort 1key", _time(sort1, (lo,), reps, lambda o: o[:1]))
    report("sort 1key stable",
           _time(sort1_stable, (lo,), reps, lambda o: o[:1]))
    report("sort 1key+1payload",
           _time(sort1p, (lo, hi), reps, lambda o: o[0][:1]))
    report("sort 2key", _time(sort2, (hi, lo), reps, lambda o: o[0][:1]))
    report("sort 2key+payload (sort3)",
           _time(sort2p, (hi, lo, cnt), reps, lambda o: o[0][:1]))
    report("sort 2key+payload stable",
           _time(sort2p_stable, (hi, lo, cnt), reps, lambda o: o[0][:1]))

    # batched independent rows (same total elements)
    for G in (4, 16, 64):
        n_row = N // G
        x2 = lo.reshape(G, n_row)

        @jax.jit
        def sortrows(x):
            return lax.sort((x,), dimension=1, num_keys=1,
                            is_stable=False)[0]

        report(f"sort 1key rows {G}x{n_row//1024}K",
               _time(sortrows, (x2,), reps, lambda o: o[0, :1]))
        y2 = hi.reshape(G, n_row)

        @jax.jit
        def sortrows2(a, b):
            return lax.sort((a, b), dimension=1, num_keys=2,
                            is_stable=False)

        report(f"sort 2key rows {G}x{n_row//1024}K",
               _time(sortrows2, (y2, x2), reps, lambda o: o[0][0, :1]))

    # sort at other sizes (scaling curve, 2key)
    for n_s in (1 << 21, 1 << 22, 1 << 24, 1 << 25):
        if args.quick and n_s > (1 << 24):
            continue
        h_s = jax.device_put(jnp.asarray(hi_np[: n_s] if n_s <= N else
                                         np.tile(hi_np, 4)[:n_s]))
        l_s = jax.device_put(jnp.asarray(lo_np[: n_s] if n_s <= N else
                                         np.tile(lo_np, 4)[:n_s]))
        report(f"sort 2key n={n_s >> 20}M",
               _time(sort2, (h_s, l_s), reps, lambda o: o[0][:1]), n=n_s)

    # ---------------- bitonic merge of two sorted runs ----------------
    def _cmpx2(h, l, d):
        n = h.shape[0]
        hh = h.reshape(n // (2 * d), 2, d)
        ll = l.reshape(n // (2 * d), 2, d)
        h0, h1 = hh[:, 0], hh[:, 1]
        l0, l1 = ll[:, 0], ll[:, 1]
        swap = (h1 < h0) | ((h1 == h0) & (l1 < l0))
        nh = jnp.stack(
            [jnp.where(swap, h1, h0), jnp.where(swap, h0, h1)], axis=1
        ).reshape(n)
        nl = jnp.stack(
            [jnp.where(swap, l1, l0), jnp.where(swap, l0, l1)], axis=1
        ).reshape(n)
        return nh, nl

    @jax.jit
    def merge2(ah, al, bh, bl):
        h = jnp.concatenate([ah, bh[::-1]])
        l = jnp.concatenate([al, bl[::-1]])
        d = h.shape[0] // 2
        while d >= 1:
            h, l = _cmpx2(h, l, d)
            d //= 2
        return h, l

    half = N // 2
    sa_h, sa_l = np.sort(hi_np[:half]), np.sort(lo_np[:half])
    sb_h, sb_l = np.sort(hi_np[half:]), np.sort(lo_np[half:])
    d_ah = jax.device_put(jnp.asarray(sa_h))
    d_al = jax.device_put(jnp.asarray(sa_l))
    d_bh = jax.device_put(jnp.asarray(sb_h))
    d_bl = jax.device_put(jnp.asarray(sb_l))
    report("bitonic merge 2key (N total)",
           _time(merge2, (d_ah, d_al, d_bh, d_bl), reps,
                 lambda o: o[0][:1]))

    # 3-array merge (with counts)
    def _cmpx3(h, l, c, d):
        n = h.shape[0]
        hh = h.reshape(n // (2 * d), 2, d)
        ll = l.reshape(n // (2 * d), 2, d)
        cc = c.reshape(n // (2 * d), 2, d)
        h0, h1 = hh[:, 0], hh[:, 1]
        l0, l1 = ll[:, 0], ll[:, 1]
        c0, c1 = cc[:, 0], cc[:, 1]
        swap = (h1 < h0) | ((h1 == h0) & (l1 < l0))
        nh = jnp.stack(
            [jnp.where(swap, h1, h0), jnp.where(swap, h0, h1)], 1
        ).reshape(n)
        nl = jnp.stack(
            [jnp.where(swap, l1, l0), jnp.where(swap, l0, l1)], 1
        ).reshape(n)
        nc = jnp.stack(
            [jnp.where(swap, c1, c0), jnp.where(swap, c0, c1)], 1
        ).reshape(n)
        return nh, nl, nc

    @jax.jit
    def merge3(ah, al, ac, bh, bl, bc):
        h = jnp.concatenate([ah, bh[::-1]])
        l = jnp.concatenate([al, bl[::-1]])
        c = jnp.concatenate([ac, bc[::-1]])
        d = h.shape[0] // 2
        while d >= 1:
            h, l, c = _cmpx3(h, l, c, d)
            d //= 2
        return h, l, c

    cnt_h = jax.device_put(jnp.ones((half,), jnp.int32))
    report("bitonic merge 3arr (N total)",
           _time(merge3, (d_ah, d_al, cnt_h, d_bh, d_bl, cnt_h), reps,
                 lambda o: o[0][:1]))

    # merge correctness spot check
    mh, ml = merge2(d_ah, d_al, d_bh, d_bl)
    key = (np.asarray(mh).astype(np.uint64) << np.uint64(32)) | np.asarray(
        ml
    ).astype(np.uint64)
    ka = (sa_h.astype(np.uint64) << np.uint64(32)) | sa_l.astype(np.uint64)
    kb = (sb_h.astype(np.uint64) << np.uint64(32)) | sb_l.astype(np.uint64)
    want = np.sort(np.concatenate([ka, kb]))
    assert (key == want).all(), "bitonic merge incorrect!"
    print("# bitonic merge correct", file=sys.stderr)

    # ---------------- RLE scan ----------------
    from findkmer_tpu.ops.sparse import rle_val

    rle = jax.jit(rle_val)
    sh = jax.device_put(jnp.asarray(np.sort(hi_np)))
    sl = jax.device_put(jnp.asarray(np.sort(lo_np)))
    report("rle_val scan (cumsum+cummax+gather)",
           _time(rle, (sh, sl, cnt), reps, lambda o: o[:1]))

    # ---------------- scatter / gather ----------------
    for tbl_bits, upd in ((16, N), (20, N), (24, N), (30, N)):
        T = 1 << tbl_bits
        idx = jax.device_put(
            jnp.asarray(rng.integers(0, T, upd, dtype=np.int32))
        )
        tbl = jax.device_put(jnp.zeros((T,), jnp.int32))

        @jax.jit
        def scat_add(t, i):
            return t.at[i].add(1)

        report(f"scatter-add into 4^{tbl_bits//2} ({T >> 20 if T >= 1<<20 else T >> 10}{'M' if T >= 1<<20 else 'K'})",
               _time(scat_add, (tbl, idx), reps, lambda o: o[:1]), n=upd)

    # route-style scatter-set (dest, offs)
    n_dev = 8
    cap = N // n_dev * 2

    @jax.jit
    def route(d, o, v):
        buf = jnp.full((n_dev, cap), 0, jnp.int32)
        return buf.at[d, o].set(v, mode="drop")

    dest = jax.device_put(
        jnp.asarray(np.sort(rng.integers(0, n_dev, N, dtype=np.int32)))
    )
    offs = jax.device_put(jnp.asarray(rng.integers(0, cap, N, np.int32)))
    vals = jax.device_put(jnp.asarray(lo_np.astype(np.int32)))
    report("route scatter-set (8xcap)",
           _time(route, (dest, offs, vals), reps, lambda o: o[0, :1]))

    @jax.jit
    def take(x, i):
        return jnp.take(x, i)

    gidx = jax.device_put(
        jnp.asarray(np.minimum(np.arange(N), rng.integers(0, N, N)).astype(np.int32))
    )
    report("gather (take, monotone-ish idx)",
           _time(take, (lo, gidx), reps, lambda o: o[:1]))

    @jax.jit
    def scan2(x):
        c = jnp.cumsum(x)
        m = lax.cummax(x, axis=0)
        return c + m

    report("cumsum+cummax", _time(scan2, (cnt,), reps, lambda o: o[:1]))

    print("# ---- summary (Melem/s) ----", file=sys.stderr)
    for k, v in sorted(results.items(), key=lambda kv: -kv[1]):
        print(f"# {v/1e6:9.1f}  {k}", file=sys.stderr)
    return 0


if __name__ == "__main__":
    sys.exit(main())
