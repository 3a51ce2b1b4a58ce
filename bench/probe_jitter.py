"""Characterize run-to-run spread of the k=8 dense step.

Timestamps each phase of >= 20 identical passes in ONE process:

  dispatch_s  time for the host to ISSUE the 8 async step calls.  The
              steps are donated jit calls; issuing should be ~ms.  If
              this varies, the variance is in the dispatch path
              (host-side serialization), not on the device.
  sync_s      time from last dispatch to completion = device execution
              + queue drain.  If dispatch_s is flat and sync_s varies,
              the variance is on the device or in the execution queue.
  probe_s     a 4 MB D2H copy after each pass — recorded to show
              whether transfer time correlates.

Run on the GPU:  python -m bench.probe_jitter [passes]
Appends one JSON line per pass to stdout; summary (min/p50/max and the
dispatch-vs-sync attribution) at the end.
"""

from __future__ import annotations

import json
import sys
import time

import jax

from bench.steps import setup_jax


def main(passes: int = 24) -> int:
    jax = setup_jax()
    import numpy as np
    import jax.numpy as jnp

    from findkmer_tpu.config import Config
    from findkmer_tpu.models.counter import KmerCounter

    batch_rows, chunk_len, steps = 256, 65536, 8
    cfg = Config(k=8, batch_rows=batch_rows, chunk_len=chunk_len)
    counter = KmerCounter(cfg)
    rng = np.random.default_rng(0)
    host_rows = rng.integers(
        0, 4, (batch_rows, cfg.row_len), dtype=np.uint8
    )
    host_rows[rng.random(host_rows.shape) < 0.01] = 4
    rows = jax.device_put(jnp.asarray(host_rows))
    bases = batch_rows * chunk_len * steps

    state = counter.init_state()
    state = counter.step(state, rows)  # compile + warm
    jax.block_until_ready(state.counts)

    def probe() -> float:
        x = jax.device_put(np.ones((1, 1 << 20), np.uint32))
        x.block_until_ready()
        t0 = time.perf_counter()
        _ = np.asarray(x)
        return time.perf_counter() - t0

    recs = []
    for i in range(passes):
        t0 = time.perf_counter()
        per_step = []
        for _ in range(steps):
            ts = time.perf_counter()
            state = counter.step(state, rows)
            per_step.append(round(time.perf_counter() - ts, 4))
        t1 = time.perf_counter()
        jax.block_until_ready(state.counts)
        t2 = time.perf_counter()
        rec = {
            "pass": i,
            "dispatch_s": round(t1 - t0, 4),
            "sync_s": round(t2 - t1, 4),
            "gbase_s": round(bases / (t2 - t0) / 1e9, 3),
            "probe_s": round(probe(), 4),
            "per_step_dispatch_s": per_step,
        }
        recs.append(rec)
        print(json.dumps(rec), flush=True)

    def dist(key):
        v = sorted(r[key] for r in recs)
        return {
            "min": v[0],
            "p50": v[len(v) // 2],
            "max": v[-1],
        }

    summary = {
        "summary": True,
        "passes": passes,
        "dispatch_s": dist("dispatch_s"),
        "sync_s": dist("sync_s"),
        "gbase_s": dist("gbase_s"),
        "probe_s": dist("probe_s"),
    }
    # attribution: which phase explains the throughput spread?
    lo = min(recs, key=lambda r: r["gbase_s"])
    hi = max(recs, key=lambda r: r["gbase_s"])
    summary["slowest_vs_fastest"] = {
        "slow": {k: lo[k] for k in ("gbase_s", "dispatch_s", "sync_s",
                                    "probe_s")},
        "fast": {k: hi[k] for k in ("gbase_s", "dispatch_s", "sync_s",
                                    "probe_s")},
    }
    print(json.dumps(summary), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(int(sys.argv[1]) if len(sys.argv) > 1 else 24))
