"""Probe: decompose the k=21 sparse INGEST cost.

Times each piece of the sparse step's ingest against its analytic floor
(the extraction ALU and a 6 B/window append):

  step        counter.step end-to-end (no compaction in window)
  ingest      the production _ingest jit (extract+append, donated)
  codes       _batch_codes alone (extract incl. stack+flatten)
  codes_sum   extraction fused into a scalar reduce (no 6B/window
              materialization) — the pure ALU + input-read bound
  append      _append of pre-extracted parts (pure dynamic_update_slice
              into the donated 1.6 GB raw buffers)

Run on the GPU: python -m bench.probe_ingest
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

    from findkmer_tpu.config import Config
    from findkmer_tpu.models.counter import (
        KmerCounter, _append, _batch_codes, _ingest,
    )
    from findkmer_tpu.pipeline import _numpy_pack_rows

    k = 21
    batch_rows, chunk_len = 512, 65536
    bases = batch_rows * chunk_len
    cfg = Config(
        k=k, batch_rows=batch_rows, chunk_len=chunk_len,
        sparse_capacity=1 << 28, sparse_expected_entries=bases * 8,
    )
    counter = KmerCounter(cfg)
    rng = np.random.default_rng(0)
    R = cfg.row_len
    R8 = (R + 7) // 8 * 8
    work = rng.integers(
        0, 4, (batch_rows - 1) * chunk_len + R, dtype=np.uint8
    )
    packed, validbits = _numpy_pack_rows(work, batch_rows, chunk_len, R, R8)
    rows = (
        jax.device_put(jnp.asarray(packed)),
        jax.device_put(jnp.asarray(validbits)),
    )

    def report(name, dt, n=1):
        per = dt / n
        print(json.dumps({
            "probe": f"ingest_{name}",
            "ms_per_batch": round(per * 1e3, 3),
            "ns_per_base": round(per / bases * 1e9, 4),
            "mbase_s": round(bases / per / 1e6, 1),
        }))
        sys.stdout.flush()

    # --- 1. counter.step end-to-end, no compaction in the window ---
    REPS = 6
    state = counter.init_state()
    state = counter.step(state, rows)          # compile + warm
    jax.block_until_ready(state.raw[-1][:4096])
    state = counter.init_state()
    t0 = time.perf_counter()
    for _ in range(REPS):
        state = counter.step(state, rows)
    jax.block_until_ready(state.raw[-1][:4096])
    report("step", time.perf_counter() - t0, REPS)
    n_slots = state.fill // REPS
    del state

    # --- 2. the production _ingest jit (donated bufs) ---
    from findkmer_tpu.ops import sparse as sparse_ops
    cap = 1 << 28
    dts = (sparse_ops.hi_dtype(k), np.uint32)
    bufs = tuple(
        jnp.full((cap,), sparse_ops.sent_of(dt), dt) for dt in dts
    )
    bufs = _ingest(bufs, rows, jnp.int32(0), k, False, R)  # warm
    jax.block_until_ready(bufs[-1][:4096])
    t0 = time.perf_counter()
    for i in range(REPS):
        bufs = _ingest(bufs, rows, jnp.int32(i * n_slots), k, False, R)
    jax.block_until_ready(bufs[-1][:4096])
    report("ingest", time.perf_counter() - t0, REPS)

    # --- 3. extraction alone (incl. 16-stream stack + flatten) ---
    parts = _batch_codes(rows, k, False, R)
    jax.block_until_ready(parts[-1][:4096])
    t0 = time.perf_counter()
    for _ in range(REPS):
        parts = _batch_codes(rows, k, False, R)
    jax.block_until_ready(parts[-1][:4096])
    report("codes", time.perf_counter() - t0, REPS)

    # --- 4. extraction fused into a reduce: ALU + input-read bound ---
    import functools

    @functools.partial(
        jax.jit, static_argnames=("kk", "RR")
    )
    def codes_sum(b, kk, RR):
        p = _batch_codes(b, kk, False, RR)
        return sum(jnp.sum(q.astype(jnp.uint32)) for q in p)

    s = codes_sum(rows, k, R)
    int(s)
    t0 = time.perf_counter()
    for _ in range(REPS):
        s = codes_sum(rows, k, R)
    int(s)
    report("codes_sum", time.perf_counter() - t0, REPS)

    # --- 5. append of pre-extracted parts (pure d_u_s write) ---
    parts = tuple(jnp.asarray(p) for p in parts)
    bufs = _append(bufs, parts, jnp.int32(0))  # warm
    jax.block_until_ready(bufs[-1][:4096])
    t0 = time.perf_counter()
    for i in range(REPS):
        bufs = _append(bufs, parts, jnp.int32(i * n_slots))
    jax.block_until_ready(bufs[-1][:4096])
    report("append", time.perf_counter() - t0, REPS)


if __name__ == "__main__":
    main()
