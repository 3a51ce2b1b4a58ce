"""Manual randomized config-space fuzz vs the scalar oracle (not pytest-collected).

Usage: python tests/fuzz_oracle.py [seed] [n_trials]  (CPU backend).
Randomizes k 1..31, canonical, chunk/batch geometry, table mode, hist
algorithm, N/lowercase/IUPAC noise density, and record counts; each
trial diffs the full pipeline against oracle/scalar.py; sparse k>=11
trials sometimes force disk spill (tiny capacity + eager compaction).
Round-4 sweeps: seeds 1 (80), 42 (300), 11 (100, incl. forced-spill
trials); 0 failures."""
import os, sys, traceback
if os.environ.get("FINDKMER_FUZZ_ON_DEVICE", "0") != "1":
    # default: CPU backend; FINDKMER_FUZZ_ON_DEVICE=1 runs the same
    # trials on the accelerator JAX finds (each new (k, geometry) shape
    # pays a compile — keep n_trials small)
    os.environ["JAX_PLATFORMS"] = "cpu"
import numpy as np
_here = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.dirname(_here)); sys.path.insert(0, os.path.join(os.path.dirname(_here), "tests"))
from findkmer_tpu.config import Config
from test_vs_oracle import count_text, spectrum_to_dict, oracle_dict

rng = np.random.default_rng(int(sys.argv[1]) if len(sys.argv) > 1 else 0)
N = int(sys.argv[2]) if len(sys.argv) > 2 else 60
BASES = np.array(list("ACGT"))
fails = 0
for trial in range(N):
    k = int(rng.integers(1, 32))
    recs = []
    for _ in range(int(rng.integers(1, 5))):
        L = int(rng.integers(0, 3000))
        arr = np.array(BASES[rng.integers(0, 4, L)], dtype="U1")
        for ch, p in (("N", float(rng.uniform(0, .08))), ("n", .01),
                      ("R", .01), ("a", float(rng.uniform(0, .3)))):
            arr[rng.random(L) < p] = ch
        recs.append("".join(arr))
    if rng.integers(4) == 0:
        # repeat-heavy trial: duplicated records (+ sometimes a long
        # homopolymer) drive n_multi ~ distinct and counts > 255, the
        # count-plane/escape legs of the v2 finalize wire
        recs = recs * int(rng.integers(2, 5))
        if rng.integers(2) == 0 and recs:
            recs[0] = "A" * int(rng.integers(300, 800)) + recs[0]
    text = "".join(f">r{i}\n{s}\n" for i, s in enumerate(recs))
    canonical = bool(rng.integers(2))
    mode = str(rng.choice(["auto", "sparse"])) if k >= 6 else "auto"
    extra = {}
    spill_dir = None
    if mode == "sparse" and k >= 11 and rng.integers(3) == 0:
        # force disk spill: tiny distinct capacity + eager compaction
        import tempfile
        spill_dir = tempfile.mkdtemp(prefix="fkspill")
        extra = dict(spill_dir=spill_dir, sparse_capacity=2048,
                     sparse_compact_entries=1024)
    else:
        extra = dict(sparse_capacity=1 << 16)
    cfg = Config(
        k=k, canonical=canonical,
        chunk_len=int(rng.choice([64, 128, 256, 1024])),
        batch_rows=int(rng.choice([1, 2, 4, 8])),
        table_mode=mode,
        hist=str(rng.choice(["auto", "scatter", "sort", "onehot"])),
        **extra,
    )
    tag = (f"trial={trial} k={k} canon={canonical} chunk={cfg.chunk_len} "
           f"rows={cfg.batch_rows} mode={cfg.table_mode} hist={cfg.hist}"
           f"{' spill' if spill_dir else ''}")
    try:
        spectrum, _ = count_text(text, cfg)
        got = spectrum_to_dict(spectrum, k)
        want = oracle_dict(text, k, canonical)
        if got != want:
            fails += 1
            bad = {kk for kk in set(want) | set(got)
                   if want.get(kk) != got.get(kk)}
            print(f"FAIL {tag} diffs={len(bad)} sample="
                  f"{[(kk, want.get(kk), got.get(kk)) for kk in list(bad)[:3]]}")
    except Exception as e:
        fails += 1
        print(f"ERROR {tag}: {type(e).__name__}: {e}")
        traceback.print_exc(limit=2)
    finally:
        if spill_dir:
            import shutil
            shutil.rmtree(spill_dir, ignore_errors=True)
    if (trial + 1) % 10 == 0:
        print(f"...{trial + 1}/{N} ok so far, fails={fails}", flush=True)
print(f"done: {N} trials, {fails} failures")
