"""Prove that the counting engine runs on an NVIDIA GPU, bit-exact.

    python chip_smoke.py                # one card: every phase below
    python chip_smoke.py --devices 4    # four cards: the mesh paths only

Phases (one card), each timed, with the device's peak bytes after it:

1. device check: JAX must run on a GPU and the native C library must
   load; anything else exits 1 with no result line (there is no CPU
   fallback, and no numpy fallback for the host side);
2. the on-device oracle subset of the tests (`pytest --on-device`), in
   this process, so one process holds the card;
3. `findkmer selftest`: dense k=4, sparse k=13, canonical k=21 against its
   built-in scalar counter;
4. end to end at chr scale: a seeded 100 Mbp multi-record FASTA (N runs,
   soft-masked runs, interspersed repeats, microsatellites) counted
   through the CLI at k=8 (dense scatter), k=15 (narrow sparse) and
   k=21 --canonical (wide sparse, ordered finalize, O_DIRECT write of
   about 2.4 GB of TSV).  Each output file must equal an independent
   numpy reference (rolling 2-bit codes, canonical fold, np.bincount or
   np.unique) in every k-mer and every count.

`--devices 4` runs only `count --devices 4` on the same genome: k=4 with
`--merge psum` (the onehot histogram under shard_map), k=8 with `--merge
psum` and `--merge psum_scatter`, k=15 `--table-mode direct
--merge all_to_all` (a 4 GiB table sharded over the cards) and k=21 with
the dp_sparse merge, each against the numpy reference.

Counts are integers, so every comparison is exact (tolerance zero).  No
floating-point matmul is on these paths, so TF32 cannot enter.

The last line of stdout is one JSON object,
{"ok": true, "device": {"platform", "kind", "count"}}, printed only when
every phase passed.  Any failure raises and exits non-zero.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import tempfile
import time
from concurrent.futures import ThreadPoolExecutor

import numpy as np

REPO = os.path.dirname(os.path.abspath(__file__))

# ASCII -> 2-bit code (A/C/G/T either case), 4 for anything else
_LUT = np.full(256, 4, np.uint8)
for _i, _b in enumerate(b"ACGT"):
    _LUT[_b] = _i
    _LUT[_b + 32] = _i


# ---------------------------------------------------------------- genome
def make_genome(mbp: float, seed: int = 0):
    """Seeded multi-record FASTA content: a list of (name, ASCII bytes).

    About `mbp` million bases of uniform random sequence with what a
    reference assembly carries: N runs (gaps), soft-masked (lowercase)
    runs, interspersed repeat copies, and microsatellites whose k-mers
    reach counts above 255.  Split into 24 records of uneven length plus
    two shorter than any k used here."""
    rng = np.random.default_rng(seed)
    n = int(mbp * 1e6)
    seq = np.frombuffer(b"ACGT", np.uint8)[rng.integers(0, 4, n, np.uint8)]
    seq = seq.copy()

    def spans(count, lo, hi):
        lens = rng.integers(lo, hi, count)
        starts = rng.integers(0, max(1, n - hi), count)
        return zip(starts.tolist(), lens.tolist())

    scale = max(1, n // 1_000_000)
    for a, ln in spans(20 * scale, 300, 6000):  # interspersed repeats
        src = int(rng.integers(0, n - ln))
        seq[a:a + ln] = seq[src:src + ln]
    for a, ln in spans(2 * scale, 50, 500):  # microsatellites
        unit = seq[a:a + int(rng.integers(1, 7))].copy()
        seq[a:a + ln] = np.resize(unit, ln)
    for a, ln in spans(40 * scale, 100, 20000):  # soft-masked runs
        seq[a:a + ln] |= 32
    for a, ln in spans(2 * scale, 1, 50000):  # assembly gaps
        seq[a:a + ln] = ord("N")
    seq[rng.integers(0, n, 10 * scale)] = ord("N")  # single Ns
    cuts = np.sort(rng.choice(np.arange(1, n), 23, replace=False))
    records = [
        (f"chr{i + 1} synthetic", part.tobytes())
        for i, part in enumerate(np.split(seq, cuts))
    ]
    records += [("tiny1", b"ACGTA"), ("tiny2", b"")]
    return records


def write_fasta(path: str, records, width: int = 80) -> None:
    with open(path, "wb") as f:
        for name, s in records:
            f.write(b">" + name.encode() + b"\n")
            full = len(s) // width * width
            if full:
                block = np.full((full // width, width + 1), 10, np.uint8)
                block[:, :width] = np.frombuffer(
                    s, np.uint8, full
                ).reshape(-1, width)
                f.write(block.tobytes())
            if len(s) > full:
                f.write(s[full:] + b"\n")


# ------------------------------------------------------ numpy reference
def encode_records(records) -> np.ndarray:
    """Records -> one uint8 code array (0..3, 4 = not a base), records
    joined by a 4 so that no window spans two records."""
    parts = []
    for _, s in records:
        parts.append(_LUT[np.frombuffer(s, np.uint8)])
        parts.append(np.full(1, 4, np.uint8))
    return np.concatenate(parts)


# the reference runs in chunks on a thread pool (numpy releases the GIL),
# so 100 Mbp takes seconds rather than minutes
_WORKERS = min(32, os.cpu_count() or 1)
_CHUNK = 1 << 22  # windows (or spectrum lines) per work item


def _pmap(fn, items):
    with ThreadPoolExecutor(_WORKERS) as ex:
        return list(ex.map(fn, items))


def _chunk_windows(codes: np.ndarray, k: int, canonical: bool, a: int):
    """2-bit codes of the valid length-k windows starting in
    [a, a + _CHUNK) (first base in the top bits), folded to
    min(code, revcomp code) when canonical."""
    m = min(_CHUNK, codes.size - k + 1 - a)
    seg = codes[a:a + m + k - 1]
    bad = np.concatenate([[0], np.cumsum(seg == 4, dtype=np.int64)])
    valid = bad[k:k + m] == bad[:m]
    b = (seg & 3).astype(np.uint64)
    fwd = np.zeros(m, np.uint64)
    for j in range(k):
        fwd <<= np.uint64(2)
        fwd |= b[j:j + m]
    if canonical:
        rc = np.zeros(m, np.uint64)
        for j in range(k):
            rc |= (np.uint64(3) - b[j:j + m]) << np.uint64(2 * j)
        np.minimum(fwd, rc, out=fwd)
    return fwd[valid]


def reference_spectrum(codes: np.ndarray, k: int, canonical: bool):
    """(sorted distinct k-mer codes uint64, counts int64) of every valid
    window: np.bincount for k <= 10, else np.unique per bucket of the
    top three bases (buckets concatenate in code order)."""
    starts = range(0, max(0, codes.size - k + 1), _CHUNK)

    def window_counts(a):
        w = _chunk_windows(codes, k, canonical, a)
        return np.bincount(w.astype(np.int64), minlength=4 ** k)

    if k <= 10:
        counts = sum(_pmap(window_counts, starts), np.zeros(4 ** k, np.int64))
        (present,) = np.nonzero(counts)
        return present.astype(np.uint64), counts[present].astype(np.int64)
    shift, n_buckets = np.uint64(2 * k - 6), 64

    def bucketed(a):
        w = _chunk_windows(codes, k, canonical, a)
        top = (w >> shift).astype(np.uint8)
        edges = np.concatenate(
            [[0], np.cumsum(np.bincount(top, minlength=n_buckets))]
        )
        w = w[np.argsort(top, kind="stable")]
        return [w[edges[i]:edges[i + 1]] for i in range(n_buckets)]

    parts = _pmap(bucketed, starts)

    def unique(i):
        return np.unique(np.concatenate([p[i] for p in parts]),
                         return_counts=True)

    done = _pmap(unique, range(n_buckets))
    return (np.concatenate([np.empty(0, np.uint64)] + [c for c, _ in done]),
            np.concatenate([np.empty(0, np.int64)]
                           + [n.astype(np.int64) for _, n in done]))


def _parse_lines(buf: np.ndarray, k: int):
    """Whole `KMER<TAB>COUNT\n` lines in buf -> (codes, counts)."""
    ends = np.flatnonzero(buf == 10)
    starts = np.concatenate([[0], ends[:-1] + 1])
    if not np.all(buf[np.minimum(starts + k, buf.size - 1)] == 9):
        raise ValueError(f"a k-mer column is not {k} wide")
    code = np.zeros(starts.size, np.uint64)
    for j in range(k):
        ch = buf[starts + j]
        c = _LUT[ch]
        if np.any((c == 4) | (ch > 96)):
            raise ValueError("a k-mer is not uppercase ACGT")
        code <<= np.uint64(2)
        code |= c.astype(np.uint64)
    first = starts + k + 1
    ndig = ends - first
    if np.any(ndig < 1) or np.any(ndig > 19):
        raise ValueError("malformed count column")
    counts = np.zeros(starts.size, np.int64)
    for d in range(int(ndig.max())):
        has = d < ndig
        digit = buf[np.where(has, first + d, 0)].astype(np.int64) - 48
        if np.any(has & ((digit < 0) | (digit > 9))):
            raise ValueError("a count is not a decimal number")
        counts = np.where(has, counts * 10 + digit, counts)
    return code, counts


def read_spectrum_tsv(path: str, k: int):
    """A `KMER<TAB>COUNT` spectrum file -> (codes uint64, counts int64),
    in file order.  Raises on any malformed line."""
    buf = np.fromfile(path, np.uint8)
    if buf.size == 0:
        return np.empty(0, np.uint64), np.empty(0, np.int64)
    if buf[-1] != 10:
        raise ValueError(f"{path}: no trailing newline")
    # cut at line ends into pieces of about _CHUNK lines of k + 3 bytes
    step = _CHUNK * (k + 3)
    cuts = [0]
    while cuts[-1] + step < buf.size:
        at = cuts[-1] + step  # lines are at most k + 21 bytes
        nl = np.flatnonzero(buf[at:at + k + 22] == 10)
        if nl.size == 0:
            raise ValueError(f"{path}: a line longer than {k + 21} bytes")
        cuts.append(at + int(nl[0]) + 1)
    cuts.append(buf.size)
    try:
        parts = _pmap(lambda i: _parse_lines(buf[cuts[i]:cuts[i + 1]], k),
                      range(len(cuts) - 1))
    except ValueError as e:
        raise ValueError(f"{path}: {e}") from None
    return (np.concatenate([c for c, _ in parts]),
            np.concatenate([n for _, n in parts]))


def check_spectrum(path: str, k: int, want) -> int:
    """Raise unless the file holds exactly the reference spectrum;
    returns the number of distinct k-mers."""
    codes, counts = read_spectrum_tsv(path, k)
    want_codes, want_counts = want
    if not (np.array_equal(codes, want_codes)
            and np.array_equal(counts, want_counts)):
        raise AssertionError(
            f"{path}: {codes.size} k-mers / {int(counts.sum())} windows, "
            f"reference {want_codes.size} / {int(want_counts.sum())}"
        )
    return int(codes.size)


# ---------------------------------------------------------------- phases
def device_check(n_devices: int):
    """The devices JAX runs on; exits 1 unless they are n_devices GPUs."""
    import jax

    devs = jax.devices()
    if devs[0].platform != "gpu" or len(devs) < n_devices:
        print(f"chip_smoke: needs {n_devices} GPU(s); JAX found "
              f"{len(devs)} {devs[0].platform} device(s)", file=sys.stderr)
        sys.exit(1)
    return devs[:n_devices]


def native_check() -> None:
    """Exits 1 unless the native C library loaded.  Without it every count
    runs on the numpy host fallbacks, which no user's run takes, and the
    phase times would not be the engine's."""
    from findkmer_tpu.io import native

    if not native.available():
        print("chip_smoke: the native C library did not load: "
              f"{native.load_error()}", file=sys.stderr)
        sys.exit(1)


def card_lines():
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout
    return [ln.strip() for ln in out.splitlines() if ln.strip()]


# the on-device oracle subset: the chr-scale-shaped compaction, the
# oracle cases that cover canonical folds and the fixture files, and the
# device filter engine (less the two filter tests that run the CLI in a
# subprocess, which is held to the CPU)
ORACLE_SUBSET = (
    "test_chr_shaped_compaction_ordered_finalize"
    " or (test_vs_oracle and (dense_canonical or sparse_canonical"
    " or fixture or ecoli))"
    " or (test_filter and device and not cli_engine and not paired)"
)


def run_oracle_subset():
    """The on-device oracle subset, in this process (pytest --on-device)."""
    import pytest

    tests = os.path.join(REPO, "tests")
    rc = pytest.main([
        os.path.join(tests, name)
        for name in ("test_sparse.py", "test_vs_oracle.py", "test_filter.py")
    ] + [
        "-k", ORACLE_SUBSET, "--on-device", "-q", "-p", "no:cacheprovider",
        "--rootdir", REPO,
    ])
    if rc != 0:
        raise RuntimeError(f"on-device tests failed (pytest rc {rc})")


def peak_bytes(devs):
    return [d.memory_stats()["peak_bytes_in_use"] for d in devs]


def run_cli(argv):
    from findkmer_tpu import cli

    rc = cli.main([str(a) for a in argv])
    if rc != 0:
        raise RuntimeError(f"findkmer {' '.join(map(str, argv))}: rc {rc}")


def count_and_check(fasta, codes, tmp, jobs, refs, devs):
    """Run each count job through the CLI and diff its output file
    against the numpy reference (computed once per (k, canonical)).
    Each job's line ends with every device's peak bytes so far."""
    for name, k, canonical, extra in jobs:
        out = os.path.join(tmp, f"{name}.tsv")
        t0 = time.perf_counter()
        run_cli(["count", "-i", fasta, "-k", k, "-o", out]
                + (["--canonical"] if canonical else []) + extra)
        count_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        key = (k, canonical)
        if key not in refs:
            refs[key] = reference_spectrum(codes, k, canonical)
        n = check_spectrum(out, k, refs[key])
        size = os.path.getsize(out)
        os.remove(out)
        print(f"  {name}: {n} distinct k-mers, {size} bytes, equal to the "
              f"numpy reference (count {count_s:.2f} s, reference + "
              f"compare {time.perf_counter() - t0:.2f} s; peak device "
              f"bytes {peak_bytes(devs)})", flush=True)


GENOME_MBP = 100  # the repo's chr-scale input size, in millions of bases
ONE_CARD_JOBS = [
    ("k8_dense", 8, False, []),
    ("k15_sparse", 15, False, []),
    ("k21_canonical", 21, True, []),
]
FOUR_CARD_JOBS = [
    ("k4_psum", 4, False, ["--devices", 4, "--merge", "psum"]),  # onehot
    ("k8_psum", 8, False, ["--devices", 4, "--merge", "psum"]),
    ("k8_psum_scatter", 8, False,
     ["--devices", 4, "--merge", "psum_scatter"]),
    ("k15_direct_all_to_all", 15, False,
     ["--devices", 4, "--table-mode", "direct", "--merge", "all_to_all"]),
    ("k21_dp_sparse", 21, False, ["--devices", 4]),
]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--devices", type=int, choices=[1, 4], default=1)
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)

    devs = device_check(args.devices)
    import findkmer_tpu  # noqa: F401  (fails outside a checkout)

    for line in card_lines():
        print(f"card: {line}")
    native_check()
    print(f"jax devices: {len(devs)} x {devs[0].device_kind}; native C "
          f"library loaded: True", flush=True)

    def phase(name, fn, *a):
        t0 = time.perf_counter()
        fn(*a)
        print(f"phase {name}: {time.perf_counter() - t0:.2f} s, peak device "
              f"bytes {peak_bytes(devs)}", flush=True)

    with tempfile.TemporaryDirectory(prefix="chip_smoke_") as tmp:
        fasta = os.path.join(tmp, "genome.fa")

        def genome():
            records = make_genome(GENOME_MBP, args.seed)
            write_fasta(fasta, records)
            state["codes"] = encode_records(records)
            print(f"  {len(records)} records, {state['codes'].size} code "
                  f"slots, {os.path.getsize(fasta)} FASTA bytes")

        state: dict = {}
        refs: dict = {}
        if args.devices == 1:
            phase("oracle_subset_on_device", run_oracle_subset)
            phase("selftest", run_cli, ["selftest"])
            phase("genome", genome)
            phase("count_vs_numpy", count_and_check, fasta,
                  state["codes"], tmp, ONE_CARD_JOBS, refs, devs)
        else:
            phase("genome", genome)
            phase("count_4_devices_vs_numpy", count_and_check, fasta,
                  state["codes"], tmp, FOUR_CARD_JOBS, refs, devs)

    print(json.dumps({"ok": True, "device": {
        "platform": devs[0].platform,
        "kind": devs[0].device_kind,
        "count": len(devs),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
