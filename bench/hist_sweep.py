"""Time the dense counting step per accumulation method (`--hist`).

Runs the jitted dense step (window extraction + table accumulation) on a
2-bit packed batch already on the device, at the CLI's geometry
(256 rows x 65536 bases), for each k and method, and prints one JSON line
per (k, method) with the median step time over `--repeats` timed runs.
The `auto` choice in ops/histogram.py follows these numbers.

Run on the GPU: python -m bench.hist_sweep [-k 4 8 10] [--steps 10]
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import sys
import time


def sweep(jax, ks=(4, 8, 10), methods=("scatter", "sort", "onehot"),
          steps=10, repeats=5, batch_rows=256, chunk_len=65536):
    """One JSON-able dict per (k, method): step times in seconds."""
    import numpy as np

    from findkmer_tpu.config import Config
    from findkmer_tpu.models.counter import KmerCounter
    from findkmer_tpu.pipeline import _numpy_pack_rows

    out = []
    for k in ks:
        cfg = Config(k=k, batch_rows=batch_rows, chunk_len=chunk_len)
        R = cfg.row_len
        rng = np.random.default_rng(k)
        work = rng.integers(0, 4, (batch_rows - 1) * chunk_len + R,
                            dtype=np.uint8)
        work[rng.random(work.shape) < 0.01] = 4  # some N windows
        packed, validbits = _numpy_pack_rows(
            work, batch_rows, chunk_len, R, (R + 7) // 8 * 8
        )
        batch = (jax.device_put(packed), jax.device_put(validbits))
        want = None
        for method in methods:
            counter = KmerCounter(cfg.replace(hist=method))
            state = counter.step(counter.init_state(), batch)  # compile
            first = np.asarray(state.counts)
            if want is None:
                want = first
            # every method must agree before its time means anything
            assert np.array_equal(first, want), (k, method)
            times = []
            for _ in range(repeats):
                t0 = time.perf_counter()
                for _ in range(steps):
                    state = counter.step(state, batch)
                jax.block_until_ready(state.counts)
                times.append((time.perf_counter() - t0) / steps)
            step_s = statistics.median(times)
            out.append({
                "k": k, "method": method, "rows": batch_rows,
                "chunk_len": chunk_len, "step_s_median": step_s,
                "step_s_all": times,
                "bases_per_s": batch_rows * chunk_len / step_s,
            })
    return out


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("-k", type=int, nargs="+", default=[4, 8, 10])
    ap.add_argument("--methods", nargs="+",
                    default=["scatter", "sort", "onehot"])
    ap.add_argument("--steps", type=int, default=10)
    ap.add_argument("--repeats", type=int, default=5)
    ap.add_argument("--batch-rows", type=int, default=256)
    ap.add_argument("--chunk-len", type=int, default=65536)
    args = ap.parse_args(argv)
    from bench.steps import device_fields, setup_jax

    jax = setup_jax()
    dev = device_fields(jax)
    for r in sweep(jax, args.k, args.methods, args.steps, args.repeats,
                   args.batch_rows, args.chunk_len):
        print(json.dumps({**r, **dev}), flush=True)
    return 0


if __name__ == "__main__":
    sys.path.insert(
        0, os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    )
    sys.exit(main())
