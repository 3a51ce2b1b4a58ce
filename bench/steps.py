"""Shared benchmark step functions (used by repo-root bench.py and
`findkmer bench`).

Measures the jitted device counting step — window extraction + table
accumulation — with rows pre-staged in device memory (the north-star
bases/s/chip metric, BASELINE.json).
"""

from __future__ import annotations

import time


def setup_jax():
    from findkmer_tpu.utils.compile_cache import enable_compile_cache
    from findkmer_tpu.utils.shmalloc import ensure_shared_alloc

    ensure_shared_alloc()
    enable_compile_cache()
    import jax

    return jax


def device_fields(jax) -> dict:
    """The device every benchmark line names."""
    dev = jax.devices()[0]
    return {
        "platform": dev.platform,
        "device_kind": dev.device_kind,
        "device_count": len(jax.devices()),
    }


def bench_dense_step(jax, k=8, batch_rows=256, chunk_len=65536, steps=8,
                     hist="auto", canonical=False):
    """bases/s of the jitted dense counting step, data staged on the
    device."""
    import numpy as np
    import jax.numpy as jnp

    from findkmer_tpu.config import Config
    from findkmer_tpu.models.counter import KmerCounter

    cfg = Config(
        k=k, batch_rows=batch_rows, chunk_len=chunk_len, hist=hist,
        canonical=canonical,
    )
    counter = KmerCounter(cfg)
    rng = np.random.default_rng(0)
    host_rows = rng.integers(0, 4, (batch_rows, cfg.row_len), dtype=np.uint8)
    # sprinkle some Ns so validity masking isn't dead code
    mask = rng.random(host_rows.shape) < 0.01
    host_rows[mask] = 4
    rows = jax.device_put(jnp.asarray(host_rows))

    state = counter.init_state()
    state = counter.step(state, rows)  # compile + warmup
    jax.block_until_ready(state.counts)

    t0 = time.perf_counter()
    for _ in range(steps):
        state = counter.step(state, rows)
    jax.block_until_ready(state.counts)
    dt = time.perf_counter() - t0

    bases = batch_rows * chunk_len * steps
    return bases / dt, dt


def bench_sparse_step(jax, k=21, batch_rows=1024, chunk_len=65536, steps=3,
                      capacity=1 << 28, canonical=False,
                      time_finalize=False, table_mode="auto"):
    """bases/s of the sparse (log-structured) path for big k.

    Honest accounting: the timed window covers everything the device does
    to produce the exact spectrum for `steps` batches — raw-code ingest
    PLUS the final compaction (sort + RLE) — excluding only D2H/output.
    With production defaults a chr1-scale run performs exactly one
    compaction, so this window (≈50 Mbase -> one compaction) matches the
    production amortization profile.  Warmup runs one identical cycle so
    no compile lands in the timed region.

    time_finalize: additionally time counter.finalize on the timed
    pass's compacted store — the count-table merge (BASELINE metric 2:
    ordered device sort + coded-wire D2H + host assembly), measured on a
    chr-scale-shaped store (~100M windows).  Returns (bps, dt,
    finalize_s) instead of (bps, dt); the warm pass finalizes too so no
    compile lands in the timed merge.
    """
    import numpy as np
    import jax.numpy as jnp

    from findkmer_tpu.config import Config
    from findkmer_tpu.models.counter import KmerCounter

    bases = batch_rows * chunk_len * steps
    cfg = Config(
        k=k, batch_rows=batch_rows, chunk_len=chunk_len,
        sparse_capacity=capacity, canonical=canonical,
        sparse_expected_entries=bases, table_mode=table_mode,
    )
    counter = KmerCounter(cfg)
    rng = np.random.default_rng(0)
    # production wire format: 2-bit packed + validity bits (the engine
    # extracts window codes straight from the packed words)
    from findkmer_tpu.pipeline import _numpy_pack_rows

    R = cfg.row_len
    R8 = (R + 7) // 8 * 8
    work = rng.integers(
        0, 4, (batch_rows - 1) * chunk_len + R, dtype=np.uint8
    )
    packed, validbits = _numpy_pack_rows(
        work, batch_rows, chunk_len, R, R8
    )
    rows = (
        jax.device_put(jnp.asarray(packed)),
        jax.device_put(jnp.asarray(validbits)),
    )

    def run_once():
        t0 = time.perf_counter()
        state = counter.init_state()
        for _ in range(steps):
            state = counter.step(state, rows)
        state = counter.compact(state)
        jax.block_until_ready(state.store[-1])
        ingest_dt = time.perf_counter() - t0
        fin_dt = 0.0
        if time_finalize:
            t1 = time.perf_counter()
            counter.finalize(state)
            fin_dt = time.perf_counter() - t1
        return ingest_dt, fin_dt

    run_once()  # compile + warm (incl. the finalize programs)
    dt, fin_dt = run_once()
    if time_finalize:
        return bases / dt, dt, fin_dt
    return bases / dt, dt


def bench_end_to_end(jax, path, k=8, hist="auto"):
    """bases/s counting a real FASTA file host->device end to end."""
    from findkmer_tpu.config import Config
    from findkmer_tpu import pipeline

    cfg = Config(k=k, hist=hist, batch_rows=64, chunk_len=65536)
    stats = pipeline.StreamStats()
    t0 = time.perf_counter()
    pipeline.count_file(path, cfg, stats=stats)
    dt = time.perf_counter() - t0
    return stats.bases / dt, dt
