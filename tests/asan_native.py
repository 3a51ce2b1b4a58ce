"""Memory-safety harness for the native C library (manual, not
pytest-collected) — the sanitizer pass SURVEY.md §5 envisions for the
reference's C surface, applied to ours.

Drives EVERY fk_* entry point exposed by findkmer_tpu/io/native.py with
randomized AND adversarial inputs (byte soup, truncated/CRLF/garbage
FASTQ, zero-length reads, reads shorter than k, boundary offsets,
corrupted spectra) under AddressSanitizer + UBSan.  Deliberately
jax-free: whole-process ASan trips over jaxlib's C++ exception
interceptors, so the C library is
exercised in isolation where every byte of every access is checked.

Run:
  cd src/native && gcc -O1 -g -fsanitize=address,undefined \
      -fno-sanitize-recover=undefined -fno-omit-frame-pointer \
      -std=c17 -fPIC -fopenmp -shared \
      -o ../../findkmer_tpu/_native/libfindkmer_encode.so encode.c
  LD_PRELOAD=$(gcc -print-file-name=libasan.so) \
      ASAN_OPTIONS=detect_leaks=0 UBSAN_OPTIONS=print_stacktrace=1 \
      python tests/asan_native.py [seed] [n_trials]
  # then rebuild the production .so (make -C src/native) / remove the
  # sanitized copy from findkmer_tpu/_native/.

Any memory error aborts the process with an ASan report; a clean run
prints the per-function trial tallies and 'asan harness done'.
"""

import sys

import numpy as np

sys.path.insert(0, __file__.rsplit("/", 2)[0])

from findkmer_tpu.io import native  # noqa: E402  (no jax anywhere)

assert native.available(), "native library not built"

rng = np.random.default_rng(int(sys.argv[1]) if len(sys.argv) > 1 else 0)
N = int(sys.argv[2]) if len(sys.argv) > 2 else 200
HASH_MULT = np.uint64(0x9E3779B97F4A7C15)
tally = {}


def t(name):
    tally[name] = tally.get(name, 0) + 1


def rand_bytes(n):
    return rng.integers(0, 256, n, dtype=np.uint8)


def rand_fastq(n_rec, *, crlf=False, truncate=False, garbage=False):
    parts = []
    for i in range(n_rec):
        ln = int(rng.integers(0, 120))
        seq = rand_bytes(ln) % 64 + 32  # printable-ish soup
        qual = rand_bytes(ln) % 64 + 33
        eol = b"\r\n" if crlf else b"\n"
        parts.append(b"@r%d" % i + eol + seq.tobytes() + eol + b"+"
                     + eol + qual.tobytes() + eol)
    blob = b"".join(parts)
    if garbage and blob:
        blob = bytes(rand_bytes(int(rng.integers(1, 40)))) + blob
    if truncate and len(blob) > 2:
        blob = blob[: int(rng.integers(1, len(blob)))]
    return np.frombuffer(blob, np.uint8)


for trial in range(N):
    # --- encoders over full byte-value space, incl. empty ------------
    n = int(rng.integers(0, 5000))
    raw = rand_bytes(n)
    native.encode(raw); t("encode")
    native.encode_packed(raw); t("encode_packed")
    codes = native.encode_compact(raw); t("encode_compact")
    out = np.full(n + 16, 4, np.uint8)
    off = int(rng.integers(0, 17))
    m = native.encode_compact_into(
        np.ascontiguousarray(raw), out, off
    ); t("encode_compact_into")
    assert m <= n
    if m:
        native.count_acgt(out, off, m); t("count_acgt")
    native.count_valid(raw); t("count_valid")

    # --- pack_rows at random geometry --------------------------------
    k = int(rng.integers(1, 32))
    L = int(rng.integers(max(k, 1), 200))
    B = int(rng.integers(1, 9))
    R = L + k - 1
    work = rand_bytes((B - 1) * L + R) % 6  # codes 0..5 (incl. invalid)
    native.pack_rows(work, B, L, R); t("pack_rows")

    # --- fastq scan: soup / truncated / CRLF / garbage ---------------
    for kw in ({}, {"truncate": True}, {"crlf": True},
               {"garbage": True, "truncate": True}):
        buf = rand_fastq(int(rng.integers(0, 12)), **kw)
        if buf.size == 0:
            continue
        native.fastq_scan(np.ascontiguousarray(buf)); t("fastq_scan")
    # pure byte soup (never a valid record)
    soup = np.ascontiguousarray(rand_bytes(int(rng.integers(1, 400))))
    native.fastq_scan(soup); t("fastq_scan")

    # --- filter legs on a VALID synthetic block ----------------------
    k = int(rng.integers(1, 32))
    n_reads = int(rng.integers(1, 30))
    lens_l, seqs = [], []
    base_lut = np.frombuffer(b"ACGTN", np.uint8)
    for _ in range(n_reads):
        ln = int(rng.integers(0, 2 * k + 40))  # incl. reads < k
        s = rand_bytes(ln) % 5  # codes 0..4 -> ACGTN bytes
        seqs.append(base_lut[s].tobytes())
        lens_l.append(ln)
    blob = b""
    starts = np.empty(n_reads, np.int64)
    for i, s in enumerate(seqs):
        starts[i] = len(blob)
        blob += s
    buf = np.frombuffer(blob or b"\x00", np.uint8)
    lens = np.array(lens_l, np.int64)
    n_codes = int(rng.integers(0, 500))
    table = np.unique(
        rng.integers(0, 1 << min(2 * k, 62), n_codes, dtype=np.uint64)
    )
    bits = 20
    shift = 64 - bits
    bloom = np.zeros(1 << bits, bool)
    if table.size:
        bloom[((table * HASH_MULT) >> np.uint64(shift)).astype(np.int64)] = True
    canonical = bool(rng.integers(2))
    native.filter_hits(
        buf, starts, lens, k, canonical, table, bloom, shift
    ); t("filter_hits")

    joined = np.empty(n_reads, np.int64)
    pos = 0
    for i in range(n_reads):
        joined[i] = pos
        pos += lens_l[i] + 1
    work2 = np.full(pos + 8, 4, np.uint8)
    native.filter_gather_prepare(
        buf, starts, joined, lens, work2
    ); t("filter_gather_prepare")
    nwin = max(pos, 1)
    words = rng.integers(0, 1 << 32, (nwin + 31) // 32 + 2,
                         dtype=np.uint32)
    halo = int(rng.integers(0, 8))
    native.filter_bitmap_hits2(
        buf, starts, joined, lens, k, words, halo
    ); t("filter_bitmap_hits2")
    native.filter_bitmap_hits(
        buf, starts, lens, k, words, halo
    ); t("filter_bitmap_hits")
    outp = np.empty(buf.size + 8, np.uint8)
    native.filter_prepare(buf, outp); t("filter_prepare")

    # --- spectrum format / parse round trip + corruption -------------
    k = int(rng.integers(1, 32))
    ncodes = int(rng.integers(0, 300))
    codes = np.unique(rng.integers(
        0, 1 << min(2 * k, 62), ncodes, dtype=np.uint64))
    counts = rng.integers(1, 1 << 31, codes.size).astype(np.int64)
    text = native.format_spectrum(codes, counts, k, b"\t")
    t("format_spectrum")
    parsed = native.parse_spectrum(text.tobytes(), k, b"\t")
    t("parse_spectrum")
    if parsed is not None and codes.size:
        pc, pn = parsed
        assert np.array_equal(pc, codes) and np.array_equal(pn, counts)
    if text.size:
        # corrupted variants: truncation + random byte flips
        cut = bytes(text[: int(rng.integers(0, text.size))])
        native.parse_spectrum(cut, k, b"\t"); t("parse_spectrum")
        mutated = np.array(text, copy=True)
        flips = rng.integers(0, text.size, min(8, text.size))
        mutated[flips] = rand_bytes(flips.size)
        native.parse_spectrum(mutated.tobytes(), k, b"\t")
        t("parse_spectrum")

    # --- merge_runs: random sorted distinct runs ---------------------
    G = int(rng.integers(1, 12))
    runs = []
    for _ in range(G):
        m = int(rng.integers(0, 400))
        c = np.unique(rng.integers(0, 1 << 40, m, dtype=np.uint64))
        cdt = np.int64 if rng.integers(2) else np.int32
        runs.append((c, rng.integers(1, 1000, c.size).astype(cdt)))
    native.merge_runs(runs); t("merge_runs")

    if (trial + 1) % 25 == 0:
        print(f"...{trial + 1}/{N}", flush=True)

print({k2: v for k2, v in sorted(tally.items())})
print("asan harness done")
