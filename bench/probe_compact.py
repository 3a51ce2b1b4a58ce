"""Probe the k=21 compaction chain at the bench size.

The bench (bench/steps.bench_sparse_step) ingests 50.33M windows and runs
ONE raw compaction.  This probe times each piece at that exact size:

  sort2      the unstable 2-key (hi, lo) sort alone
  chain      full _compact_raw chain (sort + rle_pos + count_nonzero)
  rle        rle_pos alone (on sorted input)
  rle2       rle_pos with is_end derived from is_start (one compare chain)
  sortu64    1-key uint64 sort (x64 mode) + the (hi,lo)->u64 pack
  sort2d     row-wise 2-key sort, (16, N/16) independent rows
  chain2d    row-wise compact_raw_2d

Run:  python -m bench.probe_compact [--n N]
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
    out = fn(*args)
    jax.block_until_ready(sync_arr_of(out))
    t0 = time.perf_counter()
    for _ in range(reps):
        out = fn(*args)
    jax.block_until_ready(sync_arr_of(out))
    return (time.perf_counter() - t0) / reps


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--n", type=int, default=50331648)
    ap.add_argument("--reps", type=int, default=2)
    ap.add_argument("--x64", action="store_true")
    args = ap.parse_args()

    jax = setup_jax()
    if args.x64:
        jax.config.update("jax_enable_x64", True)
    import jax.numpy as jnp
    import numpy as np
    from jax import lax

    from findkmer_tpu.ops import sparse as sp

    N = args.n
    reps = args.reps
    rng = np.random.default_rng(0)
    print(f"# device: {jax.devices()[0]} n={N}", file=sys.stderr)

    hi_np = rng.integers(0, 1 << 10, N, dtype=np.uint32)
    lo_np = rng.integers(0, 1 << 32, N, dtype=np.uint32)
    hi = jax.device_put(jnp.asarray(hi_np))
    lo = jax.device_put(jnp.asarray(lo_np))

    def emit(name, dt):
        print(
            json.dumps(
                {"probe": name, "ms": dt * 1e3, "melem_s": N / dt / 1e6}
            )
        )
        sys.stdout.flush()

    if args.x64:
        @jax.jit
        def sortu64(hi, lo):
            u = (hi.astype(jnp.uint64) << 32) | lo.astype(jnp.uint64)
            (u,) = lax.sort((u,), num_keys=1, is_stable=False)
            return u

        emit("sortu64", _time(sortu64, (hi, lo), reps, lambda o: o[-64:]))
        return

    @jax.jit
    def sort2(hi, lo):
        return lax.sort((hi, lo), num_keys=2, is_stable=False)

    emit("sort2", _time(sort2, (hi, lo), reps, lambda o: o[1][-64:]))

    chain = partial(sp.compact_raw, cdtype=jnp.int32)
    emit("chain", _time(chain, (hi, lo), reps, lambda o: o[2][-64:]))

    shi, slo = jax.jit(sort2)(hi, lo)
    shi.block_until_ready()

    rle = jax.jit(lambda h, l: sp.rle_pos(h, l))
    emit("rle", _time(rle, (shi, slo), reps, lambda o: o[-64:]))

    @jax.jit
    def rle2(h, l):
        # is_end[i] == is_start[i+1]; one compare chain instead of two
        n = h.shape[0]
        s1h = jnp.full((1,), sp.SENTINEL, h.dtype)
        s1l = jnp.full((1,), sp.SENTINEL, jnp.uint32)
        is_start = (h != jnp.concatenate([s1h, h[:-1]])) | (
            l != jnp.concatenate([s1l, l[:-1]])
        )
        is_end = jnp.concatenate([is_start[1:], jnp.ones((1,), bool)])
        idx = jnp.arange(n, dtype=jnp.int32)
        spos = lax.cummax(jnp.where(is_start, idx, 0), axis=0)
        return jnp.where(is_end & (l != sp.SENTINEL), idx - spos + 1, 0)

    emit("rle2", _time(rle2, (shi, slo), reps, lambda o: o[-64:]))

    G = 16
    hig = hi.reshape(G, -1)
    log = lo.reshape(G, -1)

    @jax.jit
    def sort2d(h, l):
        return lax.sort((h, l), dimension=1, num_keys=2, is_stable=False)

    emit("sort2d", _time(sort2d, (hig, log), reps,
                         lambda o: o[1][:, -64:]))

    chain2d = partial(sp.compact_raw_2d, cdtype=jnp.int32)
    emit("chain2d", _time(chain2d, (hig, log), reps,
                          lambda o: o[2][:, -64:]))


if __name__ == "__main__":
    main()
