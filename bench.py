"""Benchmark entry point: device counting-step rates on the GPU.

Prints one JSON line per metric, each naming the device it ran on
(platform, device_kind, device count).  The k=8 dense-step line is
printed last, on stdout; the others go to stderr.

Metrics (BASELINE.json): bases/s of the jitted device counting step
(window extraction + table accumulation, data pre-staged on the device)
at k=8 dense and k=15 / k=21 / k=21-canonical sparse, and the k=21
count-table merge time (the ordered finalize of a ~100M-window store).

Exits non-zero when JAX finds no GPU: a rate taken on the CPU is not a
device number.
"""

from __future__ import annotations

import json
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

from bench.steps import (
    bench_dense_step,
    bench_sparse_step,
    device_fields,
    setup_jax,
)


def main() -> int:
    jax = setup_jax()
    dev = device_fields(jax)
    if dev["platform"] != "gpu":
        print(f"bench.py needs a GPU; JAX found {dev['platform']}",
              file=sys.stderr)
        return 1

    def line(metric, value, unit, out=sys.stderr, **extra):
        print(json.dumps({"metric": metric, "value": value, "unit": unit,
                          **extra, **dev}), file=out, flush=True)

    for name, kw in (
        ("bases_per_s_per_chip_k21_sparse", dict(k=21)),
        ("bases_per_s_per_chip_k21_canonical", dict(k=21, canonical=True)),
        ("bases_per_s_per_chip_k15_sparse", dict(k=15)),
    ):
        bps, dt = bench_sparse_step(jax, **kw)
        line(name, bps, "bases/s", wall_s=dt)
    # count-table merge (BASELINE metric 2): device global sort +
    # coded-wire D2H + host assembly of a 512 x 64K x 3 ~= 100.7M-window
    # store
    _, _, fin_s = bench_sparse_step(
        jax, k=21, batch_rows=512, time_finalize=True
    )
    line("finalize_merge_s_k21", fin_s, "s", windows=512 * 65536 * 3)
    k8_bps, k8_dt = bench_dense_step(jax, k=8, batch_rows=1024)
    line("bases_per_s_per_chip_k8", k8_bps, "bases/s", out=sys.stdout,
         wall_s=k8_dt)
    return 0


if __name__ == "__main__":
    sys.exit(main())
