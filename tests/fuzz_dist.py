"""Manual randomized fuzz of the DISTRIBUTED paths vs the scalar oracle
(not pytest-collected).

Usage: python tests/fuzz_dist.py [seed] [n_trials]

Runs on the 8-virtual-CPU mesh (set up by tests/conftest.py when run
under pytest; this script sets the same flags itself).  Randomizes the
mesh width (1/2/4/8), merge strategy (psum / psum_scatter / all_to_all
/ dp_sparse via merge=auto+sparse), k, canonical, chunk/batch geometry,
and input noise; every trial diffs the full distributed spectrum
against oracle/scalar.py.  Round-4 sweep: seed 3, 120 trials, 0
failures.
"""

import io
import os
import sys
import traceback

os.environ["JAX_PLATFORMS"] = "cpu"
_flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in _flags:
    os.environ["XLA_FLAGS"] = (
        _flags + " --xla_force_host_platform_device_count=8"
    )

import numpy as np

_here = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.dirname(_here))
sys.path.insert(0, _here)

from findkmer_tpu.config import Config
from findkmer_tpu.io.fasta import FastaReader
from findkmer_tpu import pipeline
from findkmer_tpu.parallel.dist import DistributedCounter, make_mesh
from test_vs_oracle import oracle_dict, spectrum_to_dict


def count_dist(text, cfg, n_dev):
    mesh = make_mesh(n_dev)
    dc = DistributedCounter(cfg, mesh)
    state = dc.init_state()
    reader = FastaReader(io.BytesIO(text.encode()))
    for rows in pipeline.batches_from_codes(
        pipeline.code_stream(reader), cfg
    ):
        state = dc.step(state, rows)
    return dc.finalize(state)


def main() -> int:
    rng = np.random.default_rng(int(sys.argv[1]) if len(sys.argv) > 1 else 0)
    N = int(sys.argv[2]) if len(sys.argv) > 2 else 60
    BASES = np.array(list("ACGT"))
    fails = 0
    for trial in range(N):
        n_dev = int(rng.choice([1, 2, 4, 8]))
        merge = str(rng.choice(["psum", "psum_scatter", "all_to_all",
                                "sparse"]))
        if merge == "sparse":
            k = int(rng.integers(11, 24))
            cfg_kw = dict(merge="auto", table_mode="sparse",
                          sparse_capacity=1 << 16)
        else:
            # direct tables: keep 4^k divisible by the mesh and small
            k = int(rng.integers(4, 9))
            cfg_kw = dict(merge=merge, table_mode="direct")
        recs = []
        for _ in range(int(rng.integers(1, 4))):
            L = int(rng.integers(0, 2500))
            arr = np.array(BASES[rng.integers(0, 4, L)], dtype="U1")
            arr[rng.random(L) < float(rng.uniform(0, 0.06))] = "N"
            arr[rng.random(L) < 0.15] = "c"
            recs.append("".join(arr))
        rep_heavy = rng.integers(4) == 0
        if rep_heavy:
            # repeat-heavy trial: duplicated records (+ sometimes a
            # homopolymer) drive the per-row count-plane/escape wire
            # legs of the dp_sparse finalize
            recs = recs * int(rng.integers(2, 5))
            if rng.integers(2) == 0 and recs:
                recs[0] = "A" * int(rng.integers(300, 800)) + recs[0]
        text = "".join(f">r{i}\n{s}\n" for i, s in enumerate(recs))
        canonical = bool(rng.integers(2))
        # batch_rows must be divisible by the mesh width, and devices
        # must be set so the batcher keeps shard-compatible tail shapes
        cfg = Config(
            k=k, canonical=canonical, devices=n_dev,
            chunk_len=int(rng.choice([64, 128, 512])),
            batch_rows=n_dev * int(rng.choice([1, 2])),
            **cfg_kw,
        )
        tag = (f"trial={trial} n_dev={n_dev} merge={merge} k={k} "
               f"canon={canonical} chunk={cfg.chunk_len} "
               f"rows={cfg.batch_rows}")
        try:
            spectrum = count_dist(text, cfg, n_dev)
            if isinstance(spectrum, tuple):
                got = spectrum_to_dict(spectrum, k)
            else:
                got = spectrum_to_dict(np.asarray(spectrum), k)
            want = oracle_dict(text, k, canonical)
            if got != want:
                fails += 1
                bad = {kk for kk in set(want) | set(got)
                       if want.get(kk) != got.get(kk)}
                print(f"FAIL {tag} diffs={len(bad)}")
        except RuntimeError as e:
            if rep_heavy and "route bucket overflowed" in str(e):
                # DESIGNED fail-fast, but ONLY for repeat-heavy trials
                # (a homopolymer spike + canonical folding concentrates
                # codes onto one shard past route_capacity_factor; the
                # engine must ERROR loudly, never drop counts).  A
                # genomic-shaped trial overflowing would be a real
                # capacity regression and still counts as a failure.
                print(f"OK(overflow-fail-fast) {tag}")
            else:
                fails += 1
                print(f"ERROR {tag}: RuntimeError: {e}")
                traceback.print_exc(limit=2)
        except Exception as e:
            fails += 1
            print(f"ERROR {tag}: {type(e).__name__}: {e}")
            traceback.print_exc(limit=2)
        if (trial + 1) % 10 == 0:
            print(f"...{trial + 1}/{N} fails={fails}", flush=True)
    print(f"done: {N} trials, {fails} failures")
    return 1 if fails else 0


if __name__ == "__main__":
    sys.exit(main())
