"""Probe: finalize coded-wire measurement (ROADMAP D6).

Measures, on the pinned 100.7M-window k=21 store (bench.py's
finalize_merge_s_k21 geometry):

  1. phase decomposition of the ordered finalize (PhaseTimers:
     global_sort / slice / d2h_start / d2h / counts) — how much of it
     is the wire;
  2. raw-transfer A/B at the live size N: one u32 plane (the lo wire)
     vs three u8 byte planes (the 3-byte wire: codes sorted, bits
     24..41 run-coded so only lo24 crosses per entry) vs the
     equivalent delta-u16 plane — the achievable wire cut;
  3. device-side cost of producing the byte planes + the 18-bit run
     boundaries (elementwise shifts + one boundary scan).

Run on the GPU:  python -m bench.probe_finalize_wire
"""

from __future__ import annotations

import json
import time

import numpy as np

import jax

from bench.steps import setup_jax


def build_store(jax, k=21, batch_rows=512, chunk_len=65536, steps=3):
    """The pinned chr-scale-shaped store (same geometry as bench.py's
    finalize_merge_s_k21 metric: 512 x 64K x 3 ~= 100.7M windows)."""
    import jax.numpy as jnp

    from findkmer_tpu.config import Config
    from findkmer_tpu.models.counter import KmerCounter
    from findkmer_tpu.pipeline import _numpy_pack_rows

    bases = batch_rows * chunk_len * steps
    cfg = Config(
        k=k, batch_rows=batch_rows, chunk_len=chunk_len,
        sparse_capacity=1 << 28, sparse_expected_entries=bases,
    )
    counter = KmerCounter(cfg)
    rng = np.random.default_rng(0)
    R = cfg.row_len
    R8 = (R + 7) // 8 * 8
    work = rng.integers(0, 4, (batch_rows - 1) * chunk_len + R,
                        dtype=np.uint8)
    packed, validbits = _numpy_pack_rows(work, batch_rows, chunk_len, R, R8)
    rows = (jax.device_put(jnp.asarray(packed)),
            jax.device_put(jnp.asarray(validbits)))
    state = counter.init_state()
    for _ in range(steps):
        state = counter.step(state, rows)
    state = counter.compact(state)
    jax.block_until_ready(state.store[-1])
    return counter, state


def main():
    import jax.numpy as jnp

    jax = setup_jax()

    from findkmer_tpu.utils.prof import PhaseTimers

    counter, state = build_store(jax)

    # warm finalize (compiles), then the timed phase-decomposed one
    counter.finalize(state)
    timers = PhaseTimers()
    t0 = time.perf_counter()
    codes, counts = counter.finalize(state, timers=timers)
    total = time.perf_counter() - t0
    n_live = int(codes.size)
    phases = {k2: round(v["total_s"], 3)
              for k2, v in timers.as_dict().items()}
    print(json.dumps({"probe": "finalize_phases", "total_s": round(total, 3),
                      "n_live": n_live, "phases": phases}), flush=True)

    # ---- raw-transfer A/B at the live size ----------------------------
    N = n_live
    lo32 = jax.device_put(jnp.arange(N, dtype=jnp.uint32))
    b0 = jax.device_put(jnp.zeros(N, jnp.uint8))
    b1 = jax.device_put(jnp.ones(N, jnp.uint8))
    b2 = jax.device_put(jnp.full(N, 2, jnp.uint8))
    d16 = jax.device_put(jnp.zeros(N, jnp.uint16))
    for arr in (lo32, b0, b1, b2, d16):
        arr.block_until_ready()

    def pull(arrs):
        t0 = time.perf_counter()
        outs = [np.asarray(a) for a in arrs]
        dt = time.perf_counter() - t0
        return dt, sum(o.nbytes for o in outs)

    pull([lo32])  # warm the pull path
    t_u32, by_u32 = pull([lo32])
    t_3b, by_3b = pull([b0, b1, b2])
    t_u16, by_u16 = pull([d16])
    t_u16e, by_u16e = pull([d16, b0])  # u16 delta + escape byte plane
    print(json.dumps({
        "probe": "wire_ab", "n": N,
        "u32_s": round(t_u32, 3), "u32_mb": round(by_u32 / 1e6, 1),
        "bytes3_s": round(t_3b, 3), "bytes3_mb": round(by_3b / 1e6, 1),
        "u16_s": round(t_u16, 3),
        "u16_plus_u8_s": round(t_u16e, 3),
    }), flush=True)

    # ---- device-side cost of the 3-byte + run-coded-hi18 transform ----
    hi16 = jax.device_put(jnp.zeros(N, jnp.uint16))
    hi16.block_until_ready()

    @jax.jit
    def to_wire(hi, lo):
        b0 = (lo & 0xFF).astype(jnp.uint8)
        b1 = ((lo >> 8) & 0xFF).astype(jnp.uint8)
        b2 = ((lo >> 16) & 0xFF).astype(jnp.uint8)
        hi18 = (hi.astype(jnp.uint32) << 8) | (lo >> 24)
        brk = jnp.concatenate(
            [jnp.ones(1, bool), hi18[1:] != hi18[:-1]]
        )
        n_runs = jnp.cumsum(brk.astype(jnp.int32))[-1]
        return b0, b1, b2, n_runs

    r = to_wire(hi16, lo32)
    jax.block_until_ready(r[0][:8])
    t0 = time.perf_counter()
    r = to_wire(hi16, lo32)
    jax.block_until_ready(r[0][:8])
    t_xform = time.perf_counter() - t0
    print(json.dumps({"probe": "wire_transform_s",
                      "value": round(t_xform, 3)}), flush=True)


if __name__ == "__main__":
    main()
