"""Probes: the candidate compaction chains end to end.

Times the composed chains the sparse engine can run:

  * sort2 with a narrow (u16) hi key (k <= 23 wide codes)
  * positional RLE (iota cummax, no gather) after sort2
  * full raw-block compaction: sort2 + positional RLE
  * store-carrying compaction: sort3 + value-RLE via associative_scan
    (segmented last-start propagation) vs via gather
  * window extraction (wide) cost at production shapes

Run:  python -m bench.probe_sort2
"""

from __future__ import annotations

import json
import sys
import time

import jax

from bench.steps import setup_jax


def _time(fn, args, reps, sync_arr_of):
    out = fn(*args)
    jax.block_until_ready(sync_arr_of(out))
    t0 = time.perf_counter()
    for _ in range(reps):
        out = fn(*args)
    jax.block_until_ready(sync_arr_of(out))
    return (time.perf_counter() - t0) / reps


def main():
    jax = setup_jax()
    import jax.numpy as jnp
    import numpy as np
    from jax import lax

    reps = 3
    rng = np.random.default_rng(0)
    print(f"# device: {jax.devices()[0]}", file=sys.stderr)

    def report(name, dt, n):
        print(json.dumps({"probe": name, "elem_per_s": n / dt,
                          "ms": dt * 1e3, "n": n}))
        sys.stdout.flush()

    SENT32 = jnp.uint32(0xFFFFFFFF)

    # ---------------- chains ----------------
    def rle_pos(hi, lo):
        """Sorted codes w/ dups (cnt implicit 1) -> cnt at run ENDS,
        0 elsewhere.  Positions are monotone: cummax is exact."""
        n = hi.shape[0]
        s1h = jnp.full((1,), SENT32, hi.dtype)
        s1l = jnp.full((1,), SENT32, jnp.uint32)
        prev_ne = (hi != jnp.concatenate([s1h, hi[:-1]])) | (
            lo != jnp.concatenate([s1l, lo[:-1]])
        )
        next_ne = (hi != jnp.concatenate([hi[1:], s1h])) | (
            lo != jnp.concatenate([lo[1:], s1l])
        )
        idx = jnp.arange(n, dtype=jnp.int32)
        spos = lax.cummax(jnp.where(prev_ne, idx, 0), axis=0)
        is_sent = lo == SENT32
        cnt = jnp.where(next_ne & ~is_sent, idx - spos + 1, 0)
        return cnt

    def rle_val_scan(hi, lo, cnt):
        """Value-RLE: run totals via segmented last-start propagation
        (associative_scan with a (value, flag) combiner — exact mod 2^32
        regardless of cumulative wrap)."""
        s1h = jnp.full((1,), SENT32, hi.dtype)
        s1l = jnp.full((1,), SENT32, jnp.uint32)
        is_start = (hi != jnp.concatenate([s1h, hi[:-1]])) | (
            lo != jnp.concatenate([s1l, lo[:-1]])
        )
        is_end = (hi != jnp.concatenate([hi[1:], s1h])) | (
            lo != jnp.concatenate([lo[1:], s1l])
        )
        cu = cnt.astype(jnp.uint32)
        C = jnp.cumsum(cu)

        def comb(a, b):
            av, af = a
            bv, bf = b
            return jnp.where(bf, bv, av), af | bf

        base0 = jnp.where(is_start, C - cu, 0)
        base, _ = lax.associative_scan(comb, (base0, is_start))
        is_sent = lo == SENT32
        out = jnp.where(is_end & ~is_sent, C - base, 0).astype(jnp.int32)
        return out

    for N in (1 << 24, 1 << 25):
        hi16 = jnp.asarray(
            rng.integers(0, 1 << 10, N, dtype=np.uint16))
        hi32 = hi16.astype(jnp.uint32)
        lo = jnp.asarray(rng.integers(0, 1 << 32, N, dtype=np.uint32))
        # ~2.5x multiplicity like chr-scale genomic data
        lo_dup = jnp.asarray(
            rng.integers(0, N // 2, N, dtype=np.uint32))
        cnt1 = jnp.ones((N,), jnp.int32)
        hi16 = jax.device_put(hi16)
        hi32 = jax.device_put(hi32)
        lo = jax.device_put(lo)
        lo_dup = jax.device_put(lo_dup)
        M = N >> 20

        @jax.jit
        def sort2_16(a, b):
            return lax.sort((a, b), num_keys=2, is_stable=False)

        @jax.jit
        def sort2_32(a, b):
            return lax.sort((a, b), num_keys=2, is_stable=False)

        report(f"sort2 u16hi n={M}M",
               _time(sort2_16, (hi16, lo), reps, lambda o: o[0][:1]), N)
        report(f"sort2 u32hi n={M}M",
               _time(sort2_32, (hi32, lo), reps, lambda o: o[0][:1]), N)

        @jax.jit
        def chain_raw(a, b):
            a, b = lax.sort((a, b), num_keys=2, is_stable=False)
            return a, b, rle_pos(a, b)

        report(f"chain raw: sort2+rlepos u16hi n={M}M",
               _time(chain_raw, (hi16, lo_dup), reps, lambda o: o[2][:1]),
               N)

        @jax.jit
        def chain_raw1(b):
            (b,) = lax.sort((b,), num_keys=1, is_stable=False)
            z = jnp.zeros_like(b, jnp.uint16)
            return b, rle_pos(z, b)

        report(f"chain raw k<=15: sort1+rlepos n={M}M",
               _time(chain_raw1, (lo_dup,), reps, lambda o: o[1][:1]), N)

        @jax.jit
        def chain_store(a, b, c):
            a, b, c = lax.sort((a, b, c), num_keys=2, is_stable=False)
            return a, b, rle_val_scan(a, b, c)

        report(f"chain store: sort3+rleval(scan) u16hi n={M}M",
               _time(chain_store, (hi16, lo_dup, cnt1), reps,
                     lambda o: o[2][:1]), N)

        @jax.jit
        def rle_only(a, b, c):
            return rle_val_scan(a, b, c)

        sh, sl = sort2_16(hi16, lo_dup)
        report(f"rle_val assoc_scan only n={M}M",
               _time(rle_only, (sh, sl, cnt1), reps, lambda o: o[:1]), N)

        @jax.jit
        def rle_pos_only(a, b):
            return rle_pos(a, b)

        report(f"rle_pos only n={M}M",
               _time(rle_pos_only, (sh, sl), reps, lambda o: o[:1]), N)

    # correctness spot check of both RLEs vs numpy
    N = 1 << 16
    hi_s = np.zeros(N, np.uint16)
    lo_s = np.sort(rng.integers(0, N // 4, N).astype(np.uint32))
    cnt_s = rng.integers(1, 5, N).astype(np.int32)
    cj = rle_pos(jnp.asarray(hi_s), jnp.asarray(lo_s))
    want = np.bincount(lo_s, minlength=N)
    got = np.zeros(N, np.int64)
    np.add.at(got, lo_s, np.asarray(cj))
    assert (got[: N // 4] == want[: N // 4]).all(), "rle_pos wrong"
    cv = rle_val_scan(jnp.asarray(hi_s), jnp.asarray(lo_s),
                      jnp.asarray(cnt_s))
    want2 = np.zeros(N, np.int64)
    np.add.at(want2, lo_s, cnt_s)
    got2 = np.zeros(N, np.int64)
    np.add.at(got2, lo_s, np.asarray(cv))
    assert (got2 == want2).all(), "rle_val wrong"
    print("# RLE variants correct", file=sys.stderr)

    # window extraction cost at production shapes (k=21 wide)
    from findkmer_tpu.ops import window as window_ops

    B, L, k = 64, 1 << 18, 21
    R = L + k - 1
    rows = jax.device_put(jnp.asarray(
        rng.integers(0, 4, (B, R), dtype=np.uint8)))

    @jax.jit
    def extract(r):
        h, l, v = window_ops.window_codes_wide(r, k, False)
        s = jnp.uint32(0xFFFFFFFF)
        return jnp.where(v, h, s).reshape(-1), jnp.where(v, l, s).reshape(-1)

    report("extract wide k=21 (B64 L256K)",
           _time(extract, (rows,), reps, lambda o: o[0][:1]), B * L)
    return 0


if __name__ == "__main__":
    sys.exit(main())
