"""Scaling-efficiency harness (BASELINE.json metric 3).

Measures the sharded counting step at each mesh width:

  * on N GPUs of one host, or on N virtual CPU devices in one process
    (--xla_force_host_platform_device_count), which shows only that the
    sharded program's collective structure scales (per-batch work stays
    constant per device, merge cost is amortized), not device time;
  * an analytic traffic count printed alongside: the all_to_all path
    moves 4 B per window between devices (SURVEY.md §6), psum moves
    4*4^k per merge.

Run: python -m bench.scaling [--devices 1 2 4 8] [--merge all_to_all]
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time


def run_scaling(n_devices_list, merge="psum", k=8, batch_rows=64,
                chunk_len=8192, steps=4):
    import numpy as np
    import jax

    from findkmer_tpu.config import Config
    from findkmer_tpu.parallel import DistributedCounter, make_mesh

    results = []
    rng = np.random.default_rng(0)
    for n in n_devices_list:
        if n > len(jax.devices()):
            continue
        cfg = Config(
            k=k, batch_rows=batch_rows * n, chunk_len=chunk_len, merge=merge,
            packed_h2d=False,  # synthetic raw rows
            table_mode="sparse" if merge == "dp_sparse" else "auto",
            # pre-size the raw buffers for the whole timed run: buffer
            # growth compiles fresh shapes, which must never land inside
            # the timed region
            sparse_expected_entries=(
                batch_rows * n * chunk_len * (steps + 2)
            ),
        )
        mesh = make_mesh(n)
        dc = DistributedCounter(cfg, mesh)
        rows = rng.integers(
            0, 4, (cfg.batch_rows, cfg.row_len), dtype=np.uint8
        )

        def _sync(st):
            # after a flush the compaction's output is st.store; syncing
            # on st.raw would wait on the FRESH (already-ready) buffer
            # and let the timed region end before the sort ran
            if getattr(st, "store", None) is not None:
                jax.block_until_ready(st.store[-1])
            elif hasattr(st, "raw"):
                jax.block_until_ready(st.raw[0])
            else:
                jax.block_until_ready(jax.tree_util.tree_leaves(st)[0])

        # warm cycle identical to the timed cycle so every shape
        # (ingest fills, compaction, merge) compiles before timing
        state = dc.init_state()
        for _ in range(steps):
            state = dc.step(state, rows)
        state = dc.flush(state)
        _sync(state)
        state = dc.init_state()
        t0 = time.perf_counter()
        for _ in range(steps):
            state = dc.step(state, rows)
        state = dc.flush(state)
        _sync(state)
        dt = time.perf_counter() - t0
        dc.finalize(state)  # compile the merge program
        t0m = time.perf_counter()
        dc.finalize(state)
        merge_dt = time.perf_counter() - t0m
        bps = cfg.batch_rows * cfg.window_len * steps / dt
        results.append(
            {
                "devices": n,
                "bases_per_s": bps,
                "merge_s": merge_dt,
                "merge": dc.merge,
            }
        )
    if results:
        base = results[0]["bases_per_s"] / results[0]["devices"]
        for r in results:
            r["scaling_efficiency"] = r["bases_per_s"] / (
                base * r["devices"]
            )
    return results


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--devices", type=int, nargs="+", default=[1, 2, 4, 8])
    ap.add_argument("--merge", default="psum",
                    choices=["psum", "psum_scatter", "all_to_all",
                             "dp_sparse", "auto"])
    ap.add_argument("-k", type=int, default=8)
    ap.add_argument("--steps", type=int, default=4)
    args = ap.parse_args(argv)
    for r in run_scaling(args.devices, args.merge, args.k, steps=args.steps):
        print(json.dumps(r))
    return 0


if __name__ == "__main__":
    sys.path.insert(
        0, os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    )
    sys.exit(main())
