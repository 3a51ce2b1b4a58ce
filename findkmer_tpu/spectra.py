"""Spectrum-file operations: parse, merge, diff (host side).

`findkmer merge` combines per-host / per-shard spectrum TSVs into one —
the host-side tail of a multi-host run (each host emits its shard's
spectrum; merging is exact because counting is associative).  Also the
tool for diffing against a reference spectrum file.

Two merge paths:
  * merge_sorted_streaming — k-way heap merge of SORTED spectrum files
    (our writers always sort — output.py) in O(buffer) memory.  A
    chr-scale k=21 spectrum is ~2.4 GB / ~99M lines per host; dict-based
    merging of N of those needs tens of GB of RAM, streaming needs MBs.
  * merge_spectra — dict-based, for small or unsorted inputs.
"""

from __future__ import annotations

import heapq
from typing import Dict, Iterable, Iterator, List, Tuple


def _dict_max() -> int:
    """Entry cap for the dict fallback paths (VERDICT round-3 weak #6:
    a chr-scale UNSORTED input would otherwise OOM-risk silently — a
    33M-key str dict is already several GB).  Sorted inputs never hit
    this: every chr-scale operation has a streaming path keyed on
    sortedness.  FINDKMER_DICT_MAX overrides."""
    import os

    try:
        return int(os.environ.get("FINDKMER_DICT_MAX", str(1 << 25)))
    except ValueError:
        return 1 << 25


def read_spectrum(path, sep: str = "\t") -> Dict[str, int]:
    """Parse a KMER<sep>COUNT file (plain or gzipped) into a dict.

    This is the small/unsorted-input fallback; it refuses inputs past
    ~33M distinct k-mers (_dict_max) with a "sort it first" error
    instead of grinding into swap — the streaming paths handle sorted
    files of any size in O(buffer) memory."""
    from findkmer_tpu.io.fasta import open_maybe_gzip

    out: Dict[str, int] = {}
    cap = _dict_max()
    sep_b = sep.encode()
    f, _ = open_maybe_gzip(path)
    with f:
        for line_no, raw in enumerate(f, 1):
            raw = raw.rstrip(b"\r\n")
            if not raw:
                continue
            try:
                kmer_b, cnt = raw.split(sep_b)
                kmer = kmer_b.decode()
                out[kmer] = out.get(kmer, 0) + int(cnt)
            except (ValueError, UnicodeDecodeError) as e:
                line = raw.decode("ascii", "replace")
                raise ValueError(
                    f"{path}:{line_no}: malformed spectrum line {line!r}"
                ) from e
            if len(out) > cap:
                raise ValueError(
                    f"{path}: more than {cap} distinct k-mers on the "
                    "in-memory dict path (input is unsorted or exotic); "
                    "normalize it first with `findkmer sort` so the "
                    "O(buffer) streaming path applies, or raise "
                    "FINDKMER_DICT_MAX"
                )
    return out


_MERGE_OPS = {"sum": lambda a, b: a + b, "min": min, "max": max}


def merge_spectra(
    paths: Iterable[str], sep: str = "\t", op: str = "sum"
) -> Dict[str, int]:
    """Combine counts across spectrum files (exact; order-independent).

    op: counter operation for k-mers present in several inputs — sum
    (default), min, or max over the PRESENT counters (kmc_tools union
    counter-calculation modes)."""
    fn = _MERGE_OPS[op]
    total: Dict[str, int] = {}
    for p in paths:
        for kmer, cnt in read_spectrum(p, sep).items():
            total[kmer] = fn(total[kmer], cnt) if kmer in total else cnt
    return total


def _infer_k(path, sep_b: bytes) -> int | None:
    """k from the first data line of a spectrum file.

    None = no C fast path: the file is empty OR its k-mers exceed the
    2-bit-code range (k > 31).  Callers must treat None as "use the
    string-level fallback", never as "no data" — a k=51 third-party
    spectrum is valid input to the line-loop paths."""
    from findkmer_tpu.io.fasta import open_maybe_gzip

    f, _ = open_maybe_gzip(path)
    with f:
        head = f.read(4096)
    for line in head.split(b"\n"):
        if line.strip():
            k = len(line.rstrip(b"\r").rsplit(sep_b, 1)[0])
            return k if 1 <= k <= 31 else None
    return None


def _parse_binary(path, k: int, sep_b: bytes):
    """One spectrum file -> (codes u64, counts i64) via the C parser.

    Returns None when the native library is missing or the input is
    exotic (unsorted, lowercase, blank lines) — callers fall back to the
    Python dict path.  read() into a numpy (shm-allocator) buffer rather
    than mmap: file-backed mmap faults ride a lazily-backed VM's slow
    path (ROADMAP D10)."""
    import os

    import numpy as np

    from findkmer_tpu.io import native

    if not native.available():
        return None
    size = os.path.getsize(path)
    if size == 0:
        return (np.empty(0, np.uint64), np.empty(0, np.int64))
    with open(path, "rb") as f:
        if f.read(2) == b"\x1f\x8b":
            return None  # gzipped: line paths handle it in O(buffers)
        f.seek(0)
        buf = np.empty(size, np.uint8)
        got = f.readinto(memoryview(buf))
    return native.parse_spectrum(buf[:got], k, sep_b)


def revcomp_codes_u64(codes, k: int):
    """Vectorized reverse complement of uint64 2-bit k-mer codes.

    Complement = bitwise NOT over the 2k code bits (A<->T, C<->G are
    bit-complements in the A=0,C=1,G=2,T=3 encoding); reversal = reverse
    the 2-bit fields of the 64-bit word, then shift the k live fields
    back down.  Same function as ops.window.revcomp_code, but numpy-
    vectorized for host-side spectrum work."""
    import numpy as np

    x = np.bitwise_not(np.asarray(codes, dtype=np.uint64))
    m2 = np.uint64(0x3333333333333333)
    x = ((x & m2) << np.uint64(2)) | ((x >> np.uint64(2)) & m2)
    m4 = np.uint64(0x0F0F0F0F0F0F0F0F)
    x = ((x & m4) << np.uint64(4)) | ((x >> np.uint64(4)) & m4)
    x = x.byteswap()
    return x >> np.uint64(64 - 2 * k)


def canonize_runs(codes, counts, k: int):
    """Fold a (codes, counts) spectrum to canonical (revcomp-min) form.

    Output is sorted by canonical code with counts of a k-mer and its
    reverse complement summed — exactly the spectrum `count --canonical`
    would have produced from the same input (oracle.canonical_str
    semantics; tests/test_spectra.py proves the equivalence)."""
    import numpy as np

    codes = np.asarray(codes, dtype=np.uint64)
    if codes.size == 0:
        return codes, np.asarray(counts, dtype=np.int64)
    canon = np.minimum(codes, revcomp_codes_u64(codes, k))
    order = np.argsort(canon, kind="stable")
    c = canon[order]
    n = np.asarray(counts, dtype=np.int64)[order]
    starts = np.empty(c.size, dtype=bool)
    starts[0] = True
    np.not_equal(c[1:], c[:-1], out=starts[1:])
    idx = np.flatnonzero(starts)
    return c[idx], np.add.reduceat(n, idx)


def canonize_spectrum_file(path, out_f, sep: str = "\t") -> int:
    """Rewrite a spectrum file in canonical form (sorted).  Returns the
    number of distinct canonical k-mers written.

    Fast path: C parse -> vectorized fold -> C format.  Fallback (native
    lib missing / exotic input): Python dict + oracle string fold."""
    sep_b = sep.encode()
    # _infer_k None = "no C fast path" (empty OR k > 31), not "no
    # data": a k=51 third-party spectrum must fold through the
    # string-level fallback, not silently write an empty file
    k = _infer_k(path, sep_b)
    # the C parse/format paths support 1-byte separators only
    parsed = (
        _parse_binary(path, k, sep_b)
        if k is not None and len(sep_b) == 1 else None
    )
    if parsed is not None:
        codes, counts = canonize_runs(parsed[0], parsed[1], k)
        _write_codes(out_f, codes, counts, k, sep_b)
        return int(codes.size)
    from oracle.scalar import canonical_str

    folded: Dict[str, int] = {}
    for kmer, cnt in read_spectrum(path, sep).items():
        ck = canonical_str(kmer.upper())
        folded[ck] = folded.get(ck, 0) + cnt
    return _write_batched(
        out_f,
        ((kmer.encode(), folded[kmer]) for kmer in sorted(folded)),
        sep_b,
    )


def merge_binary_fast(paths, out_f, sep: str = "\t") -> bool:
    """C fast path for `findkmer merge`: mmap + parse each sorted file
    to binary (code, count) runs (fk_parse_spectrum), heap-merge the
    runs in one parallel C pass, and format/write in chunks.  Returns
    False (having written nothing) when inputs are exotic (unsorted,
    lowercase, blank lines, mixed k) — callers then use the streaming
    Python merge."""
    import os

    from findkmer_tpu.io import native

    sep_b = sep.encode()
    if not native.available() or len(sep_b) != 1:
        return False
    # memory gate (same knob as the set ops): this path holds every
    # input fully parsed (~1.7x file bytes) plus the merged output —
    # at the documented multi-host chr-scale tail (N x ~2.4 GB
    # spectra) that's tens of GB, so beyond the limit the caller's
    # streaming k-way merge keeps its O(buffers) promise
    limit = int(os.environ.get("FINDKMER_SETOP_FAST_MAX", 1 << 30))
    try:
        if sum(os.path.getsize(p) for p in paths) > limit:
            return False
    except OSError:
        return False
    k = _infer_k(paths[0], sep_b)
    if k is None:
        return False
    runs = []
    for p in paths:
        parsed = _parse_binary(p, k, sep_b)
        if parsed is None:
            return False
        if parsed[0].size:
            runs.append(parsed)
    from findkmer_tpu.ops.sparse import merge_host_runs

    codes, counts = merge_host_runs(runs)
    chunk = 1 << 20
    for s0 in range(0, codes.size, chunk):
        e = min(s0 + chunk, codes.size)
        out_f.write(
            native.format_spectrum(codes[s0:e], counts[s0:e], k, sep_b)
        )
    return True


def _spectrum_lines(path, sep_b: bytes) -> Iterator[Tuple[bytes, int]]:
    """Yield (kmer, count) pairs from a spectrum file, in file order.

    No sort-order requirement — order-insensitive consumers (sketching,
    dict loads) use this directly; order-sensitive streaming merges go
    through _sorted_lines."""
    from findkmer_tpu.io.fasta import open_maybe_gzip

    f, _ = open_maybe_gzip(path)
    with f:
        for line_no, line in enumerate(f, 1):
            line = line.rstrip(b"\n").rstrip(b"\r")
            if not line:
                continue
            try:
                kmer, cnt = line.rsplit(sep_b, 1)
                yield kmer, int(cnt)
            except ValueError as e:
                raise ValueError(
                    f"{path}:{line_no}: malformed spectrum line {line!r}"
                ) from e


def _sorted_lines(path, sep_b: bytes) -> Iterator[Tuple[bytes, int]]:
    """Yield (kmer, count) pairs from a sorted spectrum file.

    Raises on out-of-order lines — the streaming merge is only exact on
    sorted inputs (every writer in this package emits sorted spectra).
    """
    prev = None
    for kmer, cnt in _spectrum_lines(path, sep_b):
        # Order check BEFORE yield: early-exiting consumers (query's
        # left==0 break, two-pointer walks) must never see an
        # out-of-order record as if it were in place.
        if prev is not None and kmer < prev:
            raise ValueError(
                f"{path}: input not sorted "
                f"({kmer!r} after {prev!r}); streaming merge needs "
                "sorted spectra — use merge --in-memory for unsorted "
                "inputs"
            )
        prev = kmer
        yield kmer, cnt


_RC_TABLE = bytes.maketrans(b"ACGT", b"TGCA")


def _is_canonical_kmer(kmer: bytes) -> bool:
    return kmer <= kmer.translate(_RC_TABLE)[::-1]


def merge_sorted_streaming(
    paths: Iterable[str],
    out_f,
    sep: str = "\t",
    zeros_k: int | None = None,
    canonical: bool = False,
    op: str = "sum",
) -> int:
    """K-way heap merge of sorted spectrum files into out_f (binary).

    Memory is O(open-file buffers) regardless of spectrum size; counts
    for equal k-mers are combined with `op` (sum/min/max over the
    present counters — kmc_tools union counter-calculation modes).
    zeros_k interleaves zero-count lines
    for every absent k-mer of length zeros_k (direct-table semantics);
    with canonical=True the interleave enumerates the CANONICAL code
    space (kmers with kmer <= revcomp(kmer)) and inputs are required to
    be canonical spectra (fold them first with `findkmer canonize`).
    Returns the number of output lines written.
    """
    sep_b = sep.encode()
    streams = [_sorted_lines(p, sep_b) for p in paths]
    merged = heapq.merge(*streams)  # (kmer, count) tuples, kmer-ordered

    expected = None
    if zeros_k is not None:
        from oracle.scalar import all_kmers, canonical_kmers

        enum = canonical_kmers if canonical else all_kmers
        expected = (k_.encode() for k_ in enum(zeros_k))

    lines = 0
    cur_kmer = None
    cur_count = 0
    buf: List[bytes] = []  # batched writes: ~64k lines per flush

    def _emit(kmer: bytes, count: int):
        nonlocal lines
        if expected is not None:
            # an input k-mer outside the enumeration (wrong length,
            # lowercase, non-ACGT) would otherwise EXHAUST the zeros
            # generator and silently garble every later line
            if len(kmer) != zeros_k or not all(
                c in b"ACGT" for c in kmer
            ):
                raise ValueError(
                    f"input k-mer {kmer.decode()!r} does not match the "
                    f"-z enumeration (k={zeros_k}, uppercase ACGT); "
                    "check -k / canonize inputs first"
                )
            if canonical and not _is_canonical_kmer(kmer):
                raise ValueError(
                    f"non-canonical k-mer {kmer.decode()!r} in input of a "
                    "canonical -z merge; fold inputs with `findkmer "
                    "canonize` first"
                )
            for want in expected:
                if want == kmer:
                    break
                buf.append(want + sep_b + b"0")
                lines += 1
        buf.append(kmer + sep_b + str(count).encode())
        lines += 1
        if len(buf) >= 65536:
            out_f.write(b"\n".join(buf) + b"\n")
            buf.clear()

    op_fn = _MERGE_OPS[op]
    for kmer, count in merged:
        if kmer == cur_kmer:
            cur_count = op_fn(cur_count, count)
        else:
            if cur_kmer is not None:
                _emit(cur_kmer, cur_count)
            cur_kmer, cur_count = kmer, count
    if cur_kmer is not None:
        _emit(cur_kmer, cur_count)
    if expected is not None:
        for want in expected:
            buf.append(want + sep_b + b"0")
            lines += 1
            if len(buf) >= 65536:
                out_f.write(b"\n".join(buf) + b"\n")
                buf.clear()
    if buf:
        out_f.write(b"\n".join(buf) + b"\n")
    return lines


def matrix_sorted_streaming(
    paths,
    out_f,
    names,
    sep: str = "\t",
    min_total: int = 0,
    min_samples: int = 0,
) -> int:
    """k-mer x sample count matrix from sorted spectrum files (binary
    out).  The multi-sample aggregation workflow of kmtricks/kmc-class
    pipelines: one header line `kmer<sep>name...`, then one row per
    k-mer of the union, counts per sample (0 where absent), k-mers in
    lexicographic order.  Memory is O(open-file buffers) — a k-way heap
    walk like merge_sorted_streaming, so chr-scale inputs stream.

    min_total drops rows whose count sum is below it; min_samples
    drops rows present (nonzero) in fewer samples.  Canonical inputs
    compare canonically as long as EVERY input is canonical (fold with
    `findkmer canonize` first — mixing is the caller's error, same
    contract as merge).  Returns data rows written (header excluded).
    """
    paths = list(paths)
    if len(names) != len(paths):
        raise ValueError(
            f"matrix needs one name per input ({len(paths)} inputs, "
            f"{len(names)} names)"
        )
    sep_b = sep.encode()
    out_f.write(
        sep_b.join([b"kmer"] + [n.encode() for n in names]) + b"\n"
    )

    def tagged(i, p):
        for kmer, cnt in _sorted_lines(p, sep_b):
            yield kmer, i, cnt

    merged = heapq.merge(*(tagged(i, p) for i, p in enumerate(paths)))
    n = len(paths)
    rows = 0
    cur: bytes | None = None
    counts = [0] * n
    buf: List[bytes] = []

    def _emit():
        nonlocal rows
        if cur is None:
            return
        if min_total and sum(counts) < min_total:
            return
        if min_samples and sum(c > 0 for c in counts) < min_samples:
            return
        buf.append(
            cur + sep_b
            + sep_b.join(str(c).encode() for c in counts)
        )
        rows += 1
        if len(buf) >= 65536:
            out_f.write(b"\n".join(buf) + b"\n")
            buf.clear()

    for kmer, i, cnt in merged:
        if kmer != cur:
            _emit()
            cur = kmer
            counts = [0] * n
        counts[i] += cnt  # duplicates within a file sum, like merge
    _emit()
    if buf:
        out_f.write(b"\n".join(buf) + b"\n")
    return rows


def spectrum_lines(
    counts: Dict[str, int], sep: str = "\t", zeros_k: int | None = None,
    canonical: bool = False,
) -> Iterable[str]:
    """Lexicographically ordered output lines.

    zeros_k: if set, emit all 4^k k-mers including zero counts —
    canonical=True enumerates only the canonical (revcomp-min) code
    space and rejects non-canonical input k-mers.
    """
    if zeros_k is not None:
        from oracle.scalar import all_kmers, canonical_kmers

        for kmer in counts:
            # outside-the-enumeration keys (wrong k, lowercase,
            # non-ACGT) would silently DROP their counts below
            if len(kmer) != zeros_k or any(
                c not in "ACGT" for c in kmer
            ):
                raise ValueError(
                    f"input k-mer {kmer!r} does not match the -z "
                    f"enumeration (k={zeros_k}, uppercase ACGT); "
                    "check -k / canonize inputs first"
                )
            if canonical and not _is_canonical_kmer(kmer.encode()):
                raise ValueError(
                    f"non-canonical k-mer {kmer!r} in input of a "
                    "canonical -z merge; fold inputs with "
                    "`findkmer canonize` first"
                )
        enum = canonical_kmers if canonical else all_kmers
        for kmer in enum(zeros_k):
            yield f"{kmer}{sep}{counts.get(kmer, 0)}"
    else:
        for kmer in sorted(counts):
            yield f"{kmer}{sep}{counts[kmer]}"


def _write_codes(out_f, codes, counts, k: int, sep_b: bytes,
                 kmers_only: bool = False) -> None:
    """Chunked C-formatted write of sorted (codes, counts) arrays."""
    from findkmer_tpu.io import native

    chunk = 1 << 20
    for s0 in range(0, codes.size, chunk):
        e = min(s0 + chunk, codes.size)
        if kmers_only:
            from findkmer_tpu.output import codes_to_kmer_bytes

            kmers = codes_to_kmer_bytes(codes[s0:e], k)
            out_f.write(b"\n".join(kmers.tolist()) + b"\n")
        else:
            out_f.write(
                native.format_spectrum(codes[s0:e], counts[s0:e], k, sep_b)
            )


def sort_spectrum_file(path, out_f, sep: str = "\t", *,
                       min_count: int = 1, max_count: int = 0,
                       set_count: int = 0,
                       kmers_only: bool = False) -> int:
    """Rewrite a spectrum file in lexicographic k-mer order, summing
    duplicate (case-folded) k-mers — normalizes third-party/unsorted
    TSVs for the streaming ops (merge/intersect/subtract need sorted
    inputs).  Returns distinct k-mers written.

    Transform knobs (kmc_tools `transform` class):
      min_count/max_count — drop k-mers outside [min_count, max_count]
        (kmc_tools `reduce -ci/-cx`; max_count 0 = unbounded).
      set_count — force every surviving counter to this value
        (kmc_tools `set_counts`).
      kmers_only — emit only the k-mer column (kmc_tools `compact`).
    """
    import numpy as np

    sep_b = sep.encode()
    raw = read_spectrum(path, sep)  # sums duplicates, any order
    d: Dict[str, int] = {}
    for km, v in raw.items():  # normalize case (same on both paths)
        u = km.upper()
        d[u] = d.get(u, 0) + v
    if min_count > 1 or max_count:
        d = {
            km: v
            for km, v in d.items()
            if v >= min_count and (not max_count or v <= max_count)
        }
    if set_count:
        d = {km: set_count for km in d}
    if not d:
        return 0
    from findkmer_tpu.io import native

    # coded fast path ONLY for uniform-length ACGT k-mers of k <= 31:
    # str_to_code is length-blind ('A' and 'AA' both code 0) and the
    # formatter re-decodes at one fixed k, so anything mixed falls to
    # the text path (which handles any content)
    klens = {len(km) for km in d}
    if (
        len(sep_b) == 1
        and native.available()
        and len(klens) == 1
        and 1 <= next(iter(klens)) <= 31
    ):
        k = next(iter(klens))
        try:
            from findkmer_tpu.ops.window import str_to_code

            codes = np.fromiter(
                (str_to_code(km) for km in d), np.uint64, len(d)
            )
        except KeyError:
            codes = None  # non-ACGT k-mers: plain text path below
        if codes is not None:
            counts = np.fromiter(d.values(), np.int64, len(d))
            order = np.argsort(codes)
            _write_codes(out_f, codes[order], counts[order], k, sep_b,
                         kmers_only=kmers_only)
            return len(d)
    if kmers_only:
        n = 0
        buf: List[bytes] = []
        for km in sorted(d):
            buf.append(km.encode())
            n += 1
            if len(buf) >= 65536:
                out_f.write(b"\n".join(buf) + b"\n")
                buf.clear()
        if buf:
            out_f.write(b"\n".join(buf) + b"\n")
        return n
    return _write_batched(
        out_f,
        ((km.encode(), d[km]) for km in sorted(d)),
        sep_b,
    )


def histo_spectrum_file(path, max_count: int = 10000, sep: str = "\t"):
    """Count-of-counts histogram of a spectrum FILE (no recount): h[m] =
    distinct k-mers with count m, m clipped to max_count (KMC
    `histogram` semantics).  C binary parse fast path; Python line loop
    for exotic inputs."""
    import numpy as np

    sep_b = sep.encode()
    # _infer_k returning None means "no C fast path" (empty file OR
    # k > 31) — NOT "no data"; the line loop below handles any k, so
    # e.g. a third-party k=51 spectrum must not yield an all-zero
    # histogram
    k = _infer_k(path, sep_b)
    parsed = (
        _parse_binary(path, k, sep_b)
        if k is not None and len(sep_b) == 1 else None
    )
    if parsed is not None:
        counts = np.minimum(parsed[1], max_count)
        counts = counts[counts > 0]
        return np.bincount(counts, minlength=max_count + 1).astype(
            np.int64
        )
    from findkmer_tpu.io.fasta import open_maybe_gzip

    h = np.zeros(max_count + 1, np.int64)
    f, _ = open_maybe_gzip(path)
    with f:
        for line_no, line in enumerate(f, 1):
            line = line.rstrip(b"\r\n")
            if not line:
                continue
            try:
                cnt = int(line.rsplit(sep_b, 1)[1])
            except (IndexError, ValueError) as e:
                raise ValueError(
                    f"{path}:{line_no}: malformed spectrum line {line!r}"
                ) from e
            if cnt > 0:
                h[min(cnt, max_count)] += 1
    return h


def diff_spectra(a: Dict[str, int], b: Dict[str, int]) -> List[str]:
    """Human-readable differences between two spectra (empty == equal)."""
    out = []
    for kmer in sorted(set(a) | set(b)):
        ca, cb = a.get(kmer, 0), b.get(kmer, 0)
        if ca != cb:
            out.append(f"{kmer}: {ca} != {cb}")
    return out


def diff_sorted_streaming(
    path_a, path_b, sep: str = "\t"
) -> Iterator[str]:
    """Yield diff_spectra-format lines for two SORTED spectrum files.

    The chr-scale diff: the two-pointer walk the other set ops use
    (_grouped), O(buffers) memory instead of two full Python dicts —
    a 2.4 GB chr-scale spectrum does not fit read_spectrum.  Raises
    the standard not-sorted error on unsorted inputs (route those
    through `findkmer sort` or `diff --in-memory`)."""
    sep_b = sep.encode()
    for kmer, (ca, cb) in _grouped([path_a, path_b], sep_b):
        ca = 0 if ca is None else ca
        cb = 0 if cb is None else cb
        if ca != cb:
            yield f"{kmer.decode()}: {ca} != {cb}"


def _grouped(paths, sep_b: bytes):
    """Iterate sorted inputs as (kmer, [count_or_None per input]) groups.

    Streams all files in lockstep (heap merge); each group lists which
    inputs contain the k-mer and with what summed count (None = absent).
    O(buffers) memory."""
    n = len(paths)

    def _tagged(p, i):
        for kmer, cnt in _sorted_lines(p, sep_b):
            yield kmer, cnt, i

    streams = [_tagged(p, i) for i, p in enumerate(paths)]
    merged = heapq.merge(*streams)
    cur = None
    counts: List = [None] * n
    for kmer, cnt, i in merged:
        if kmer != cur:
            if cur is not None:
                yield cur, counts
            cur = kmer
            counts = [None] * n
        counts[i] = cnt if counts[i] is None else counts[i] + cnt
    if cur is not None:
        yield cur, counts


def _write_batched(out_f, line_iter, sep_b: bytes) -> int:
    buf: List[bytes] = []
    lines = 0
    for kmer, count in line_iter:
        buf.append(kmer + sep_b + str(count).encode())
        lines += 1
        if len(buf) >= 65536:
            out_f.write(b"\n".join(buf) + b"\n")
            buf.clear()
    if buf:
        out_f.write(b"\n".join(buf) + b"\n")
    return lines


class _CanonizedInputs:
    """Context manager: canonize input spectra to temp files so the
    streaming set ops (which need sorted keys) can run canonical-aware.

    Folding k-mer -> min(kmer, revcomp) is not order-preserving, so
    canonical set ops cannot stream the raw inputs directly; each input
    is folded + re-sorted once (vectorized, via canonize_spectrum_file)
    and the op streams the folded files.  Already-canonical inputs pass
    through the fold unchanged, so mixing plain and canonical spectra
    is safe under canonical=True."""

    def __init__(self, paths, sep: str):
        self.paths = list(paths)
        self.sep = sep
        self.tmp: List[str] = []

    def __enter__(self) -> List[str]:
        import tempfile

        try:
            for p in self.paths:
                f = tempfile.NamedTemporaryFile(
                    "wb", suffix=".canon.tsv", delete=False
                )
                self.tmp.append(f.name)  # before folding: an exception
                try:                     # mid-fold must still clean up
                    canonize_spectrum_file(p, f, sep=self.sep)
                finally:
                    f.close()
        except BaseException:
            self.__exit__()
            raise
        return self.tmp

    def __exit__(self, *exc):
        import os

        for t in self.tmp:
            try:
                os.unlink(t)
            except OSError:
                pass
        return False


def _setop_binary_fast(paths, out_f, op: str, sep: str,
                       mode: str = "counters"):
    """C-parsed vectorized intersect/subtract (same semantics as the
    streaming versions).  Returns the written-line count, or None
    (nothing written) when inputs are exotic or too large to hold in
    RAM — callers then run the O(buffers)-memory Python line path."""
    import os

    import numpy as np

    from findkmer_tpu.io import native

    sep_b = sep.encode()
    if not native.available() or len(sep_b) != 1:
        return None
    # memory gate: this path holds every input parsed in RAM
    # (~1.7x file bytes); beyond it the streaming path keeps the
    # original O(buffers) guarantee
    limit = int(os.environ.get("FINDKMER_SETOP_FAST_MAX", 1 << 30))
    if sum(os.path.getsize(p) for p in paths) > limit:
        return None
    k = _infer_k(paths[0], sep_b)
    if k is None:
        return None
    parsed = []
    for p in paths:
        pr = _parse_binary(p, k, sep_b)
        if pr is None:
            return None
        parsed.append(pr)
    codes, counts = parsed[0]
    if op == "intersect":
        for oc, on in parsed[1:]:
            idx = np.searchsorted(oc, codes)
            np.clip(idx, 0, max(oc.size - 1, 0), out=idx)
            hit = (oc[idx] == codes) if oc.size else np.zeros(
                codes.size, bool
            )
            codes = codes[hit]
            counts = np.minimum(counts[hit], on[idx[hit]])
    elif op == "subtract" and mode == "kmers":
        keep = np.ones(codes.size, bool)
        for oc, on in parsed[1:]:
            if not oc.size:
                continue
            idx = np.searchsorted(oc, codes)
            np.clip(idx, 0, oc.size - 1, out=idx)
            keep &= oc[idx] != codes
        codes, counts = codes[keep], counts[keep]
    else:  # subtract, counters mode
        counts = counts.copy()
        for oc, on in parsed[1:]:
            if not oc.size:
                continue
            idx = np.searchsorted(oc, codes)
            np.clip(idx, 0, oc.size - 1, out=idx)
            hit = oc[idx] == codes
            counts[hit] -= on[idx[hit]]
        keep = counts > 0
        codes, counts = codes[keep], counts[keep]
    _write_codes(out_f, codes, counts, k, sep_b)
    return int(codes.size)


def intersect_sorted_streaming(
    paths, out_f, sep: str = "\t", canonical: bool = False
) -> int:
    """k-mers present in EVERY input; count = min across inputs
    (kmc_tools `intersect` semantics).  Streaming, sorted inputs.
    canonical=True folds every input to revcomp-min form first.
    Clean inputs within the memory gate take the C-parsed vectorized
    path; everything else streams in O(buffers) memory."""
    if canonical:
        with _CanonizedInputs(paths, sep) as folded:
            return intersect_sorted_streaming(folded, out_f, sep)
    n = _setop_binary_fast(paths, out_f, "intersect", sep)
    if n is not None:
        return n
    sep_b = sep.encode()

    def gen():
        for kmer, counts in _grouped(paths, sep_b):
            if all(c is not None for c in counts):
                yield kmer, min(counts)

    return _write_batched(out_f, gen(), sep_b)


def subtract_sorted_streaming(
    paths, out_f, sep: str = "\t", canonical: bool = False,
    mode: str = "counters",
) -> int:
    """First input minus the others.  Streaming, sorted inputs.

    mode="counters" (default): counts of the other inputs are
    subtracted and rows dropped at <= 0 (kmc_tools `counters_subtract`
    semantics).  mode="kmers": a k-mer is dropped entirely if PRESENT
    in any other input, counts untouched (kmc_tools `kmers_subtract`).
    canonical=True folds every input to revcomp-min form first.
    Clean inputs within the memory gate take the C-parsed vectorized
    path; everything else streams in O(buffers) memory."""
    if canonical:
        with _CanonizedInputs(paths, sep) as folded:
            return subtract_sorted_streaming(folded, out_f, sep,
                                             mode=mode)
    n = _setop_binary_fast(paths, out_f, "subtract", sep, mode=mode)
    if n is not None:
        return n
    sep_b = sep.encode()

    def gen():
        for kmer, counts in _grouped(paths, sep_b):
            if counts[0] is None:
                continue
            if mode == "kmers":
                if all(c is None for c in counts[1:]):
                    yield kmer, counts[0]
                continue
            rest = sum(c for c in counts[1:] if c is not None)
            d = counts[0] - rest
            if d > 0:
                yield kmer, d

    return _write_batched(out_f, gen(), sep_b)


# ---------------------------------------------------------------------
# set-algebra expressions over spectra (the kmc_tools `complex` class)
# ---------------------------------------------------------------------
# Grammar (left-associative; '*' binds tighter):
#   expr   := term (('+' | '-' | '~') term)*
#   term   := factor ('*' factor)*
#   factor := NAME | '(' expr ')'
# Operators (matching this package's merge/intersect/subtract
# subcommands, themselves the kmc_tools semantics):
#   A + B   union, counts sum            (merge --op sum)
#   A * B   intersection, counts min     (intersect)
#   A - B   k-mers of A absent from B    (subtract --mode kmers)
#   A ~ B   counts A minus B, kept > 0   (subtract --mode counters)
# Every node streams in O(buffers): leaves are sorted spectrum files
# (duplicates within a file sum), combinators are two-pointer walks.


def _expr_leaf(path, sep_b: bytes):
    """Sorted file -> strictly-increasing (kmer, count) stream."""
    cur = None
    tot = 0
    for kmer, cnt in _sorted_lines(path, sep_b):
        if kmer == cur:
            tot += cnt
        else:
            if cur is not None:
                yield cur, tot
            cur, tot = kmer, cnt
    if cur is not None:
        yield cur, tot


def _expr_walk2(a, b):
    """Align two strictly-increasing streams: (kmer, ca|None, cb|None)."""
    sent = object()
    ai = iter(a)
    bi = iter(b)
    av = next(ai, sent)
    bv = next(bi, sent)
    while av is not sent or bv is not sent:
        if bv is sent or (av is not sent and av[0] < bv[0]):
            yield av[0], av[1], None
            av = next(ai, sent)
        elif av is sent or bv[0] < av[0]:
            yield bv[0], None, bv[1]
            bv = next(bi, sent)
        else:
            yield av[0], av[1], bv[1]
            av = next(ai, sent)
            bv = next(bi, sent)


def _expr_op(op: str, a, b):
    for kmer, ca, cb in _expr_walk2(a, b):
        if op == "+":
            yield kmer, (ca or 0) + (cb or 0)
        elif op == "*":
            if ca is not None and cb is not None:
                yield kmer, min(ca, cb)
        elif op == "-":
            if ca is not None and cb is None:
                yield kmer, ca
        else:  # "~"
            if ca is not None:
                d = ca - (cb or 0)
                if d > 0:
                    yield kmer, d


def _expr_tokens(text: str):
    import re

    for m in re.finditer(r"[A-Za-z_][A-Za-z0-9_]*|[-+*~()]|\S", text):
        t = m.group()
        if t not in "+-*~()" and not t[0].isalpha() and t[0] != "_":
            raise ValueError(
                f"expression: unexpected {t!r} at position {m.start()}"
            )
        yield t
    yield None  # EOF


def eval_expression(text: str, inputs: Dict[str, str],
                    sep: str = "\t"):
    """Evaluate a set-algebra expression over sorted spectrum files.

    inputs maps expression NAMEs to file paths.  Returns a streaming
    (kmer bytes, count) iterator in sorted order — O(buffers) memory
    at any spectrum size."""
    sep_b = sep.encode()
    toks = _expr_tokens(text)
    cur = next(toks)

    def advance():
        nonlocal cur
        cur = next(toks)

    def factor():
        if cur == "(":
            advance()
            node = expr()
            if cur != ")":
                raise ValueError("expression: missing ')'")
            advance()
            return node
        if cur is None or cur in "+-*~)":
            raise ValueError(
                f"expression: expected a name, got {cur!r}"
            )
        name = cur
        if name not in inputs:
            raise ValueError(
                f"expression: {name!r} is not a defined input "
                f"(have: {', '.join(sorted(inputs)) or 'none'})"
            )
        advance()
        return _expr_leaf(inputs[name], sep_b)

    def term():
        node = factor()
        while cur == "*":
            advance()
            node = _expr_op("*", node, factor())
        return node

    def expr():
        node = term()
        while cur in ("+", "-", "~"):
            op = cur
            advance()
            node = _expr_op(op, node, term())
        return node

    node = expr()
    if cur is not None:
        raise ValueError(f"expression: trailing {cur!r}")
    return node


def expr_sorted_streaming(
    text: str, inputs: Dict[str, str], out_f, sep: str = "\t",
    canonical: bool = False,
) -> int:
    """`findkmer expr`: evaluate and write KMER<sep>COUNT lines.

    canonical=True folds every input to revcomp-min form first (same
    contract as the intersect/subtract subcommands)."""
    if canonical:
        names = sorted(inputs)
        with _CanonizedInputs([inputs[n] for n in names], sep) as folded:
            return expr_sorted_streaming(
                text, dict(zip(names, folded)), out_f, sep
            )
    sep_b = sep.encode()
    return _write_batched(
        out_f, eval_expression(text, inputs, sep), sep_b
    )


def query_spectrum(
    path, kmers, sep: str = "\t", canonical: bool = False
) -> Dict[str, int]:
    """Counts for specific k-mers (absent -> 0).  One streaming pass.

    canonical=True: the spectrum is canonical — each queried k-mer is
    folded to its revcomp-min form for the lookup (results keyed by the
    k-mer as queried)."""
    if canonical:
        from oracle.scalar import canonical_str

        folded = {k.upper(): canonical_str(k.upper()) for k in kmers}
        got = query_spectrum(path, sorted(set(folded.values())), sep)
        return {k: got[ck] for k, ck in folded.items()}
    sep_b = sep.encode()
    want = {k.upper().encode(): 0 for k in kmers}
    # early exit only when EVERY queried key has been seen AND the
    # scan has moved past the largest one: per-KEY tracking sums legal
    # duplicate keys (the old per-hit countdown broke before later
    # queried k-mers), and requiring all keys seen keeps the
    # round-3 guarantee that an unsorted file errors rather than
    # silently reporting a missed key as 0
    seen: set = set()
    last = max(want) if want else b""
    for kmer, cnt in _sorted_lines(path, sep_b):
        if kmer in want:
            want[kmer] += cnt
            seen.add(kmer)
        elif len(seen) == len(want) and kmer > last:
            break
    return {k.decode(): v for k, v in want.items()}


def top_n(path, n: int, sep: str = "\t") -> List[Tuple[str, int]]:
    """The n most frequent k-mers (count desc, kmer asc), one pass."""
    import heapq as hq

    if n <= 0:
        return []  # heap[0] on an empty heap would IndexError
    sep_b = sep.encode()
    # min-heap of (count, reversed-order kmer) keeps the current top n
    heap: List[Tuple[int, bytes]] = []
    for kmer, cnt in _sorted_lines(path, sep_b):
        if len(heap) < n:
            hq.heappush(heap, (cnt, _RevBytes(kmer)))
        elif (cnt, _RevBytes(kmer)) > heap[0]:
            hq.heapreplace(heap, (cnt, _RevBytes(kmer)))
    out = sorted(heap, key=lambda t: (-t[0], t[1].b))
    return [(rb.b.decode(), c) for c, rb in out]


def info_spectrum_file(path, sep: str = "\t") -> Dict[str, object]:
    """Summary statistics of a spectrum file, one streaming pass
    (kmc_tools `info` analog; works on gzipped and third-party files).

    On a sorted unique spectrum (everything this package writes) the
    stats are exact.  Unsorted files are still summarized line-by-line
    ("sorted": "no"); duplicate keys are then counted as separate
    entries, matching what any streaming consumer of that file sees."""
    from findkmer_tpu.io.fasta import open_maybe_gzip

    sep_b = sep.encode()

    # Fast path: C parse (sorted, uppercase, pure-ACGT spectra).
    k0 = _infer_k(path, sep_b)
    if k0 is not None:
        parsed = _parse_binary(path, k0, sep_b)
        if parsed is not None:
            import numpy as np

            codes, counts = parsed
            if codes.size:
                canon = bool(
                    np.all(codes <= revcomp_codes_u64(codes, k0))
                )
                singles = int((counts == 1).sum())
                return {
                    "k": k0,
                    "distinct": int(codes.size),
                    "total": int(counts.sum()),
                    "min_count": int(counts.min()),
                    "max_count": int(counts.max()),
                    "mean_count": float(counts.sum() / codes.size),
                    "singletons": singles,
                    "canonical": "yes" if canon else "no",
                    "acgt_only": "yes",
                    "sorted": "yes",
                }

    # Line path: any separator/case/order, gz ok.
    distinct = total = singles = 0
    min_c = max_c = None
    k_min = k_max = None
    srt = True
    acgt_only = True
    canonical = True
    prev = None
    acgt = frozenset(b"ACGT")
    f, _ = open_maybe_gzip(path)
    with f:
        for line_no, line in enumerate(f, 1):
            line = line.rstrip(b"\n").rstrip(b"\r")
            if not line:
                continue
            try:
                kmer, cnt_s = line.rsplit(sep_b, 1)
                cnt = int(cnt_s)
            except ValueError as e:
                raise ValueError(
                    f"{path}:{line_no}: malformed spectrum line {line!r}"
                ) from e
            ku = kmer.upper()
            if prev is not None and ku < prev:
                srt = False
            prev = ku
            if not set(ku) <= acgt:
                acgt_only = False
                canonical = False
            elif canonical and ku > ku.translate(_RC_TABLE)[::-1]:
                canonical = False
            n = len(kmer)
            k_min = n if k_min is None else min(k_min, n)
            k_max = n if k_max is None else max(k_max, n)
            distinct += 1
            total += cnt
            singles += cnt == 1
            min_c = cnt if min_c is None else min(min_c, cnt)
            max_c = cnt if max_c is None else max(max_c, cnt)
    return {
        "k": (k_min if k_min == k_max else f"{k_min}..{k_max}")
        if k_min is not None else 0,
        "distinct": distinct,
        "total": total,
        "min_count": min_c or 0,
        "max_count": max_c or 0,
        "mean_count": (total / distinct) if distinct else 0.0,
        "singletons": singles,
        "canonical": "yes" if (canonical and distinct and acgt_only)
        else "no",
        "acgt_only": "yes" if acgt_only else "no",
        "sorted": "yes" if srt else "no",
    }


def _similarity_binary(path_a, path_b, sep_b: bytes):
    """C-parsed vectorized similarity accumulators, or None (exotic
    inputs — caller streams)."""
    import numpy as np

    ka, kb = _infer_k(path_a, sep_b), _infer_k(path_b, sep_b)
    if ka is None or kb is None or ka != kb:
        return None
    pa = _parse_binary(path_a, ka, sep_b)
    pb = _parse_binary(path_b, kb, sep_b)
    if pa is None or pb is None:
        return None
    ca, na = pa
    cb, nb = pb
    na = na.astype(np.float64)
    nb = nb.astype(np.float64)
    shared, ia, ib = np.intersect1d(
        ca, cb, assume_unique=True, return_indices=True
    )
    am, bm = na[ia], nb[ib]
    return {
        "k": ka,
        "distinct_a": int(ca.size),
        "distinct_b": int(cb.size),
        "shared": int(shared.size),
        "total_a": int(na.sum()),
        "total_b": int(nb.sum()),
        "sum_min": float(np.minimum(am, bm).sum()),
        # union multiset: max over shared keys + every non-shared count
        "sum_max": float(
            np.maximum(am, bm).sum()
            + (na.sum() - am.sum()) + (nb.sum() - bm.sum())
        ),
        "dot": float((am * bm).sum()),
        "norm_a": float((na * na).sum()),
        "norm_b": float((nb * nb).sum()),
    }


def similarity_spectra(
    path_a, path_b, sep: str = "\t", canonical: bool = False
) -> Dict[str, object]:
    """Similarity metrics between two sorted spectra (Mash/sourmash
    tool-class): Jaccard and containment over the distinct k-mer sets,
    weighted (multiset) Jaccard and cosine over the counts, and the
    Mash distance estimate -ln(2j/(1+j))/k.

    Streams both files with a two-pointer walk (O(buffers) memory);
    clean same-k inputs ride the C parser + numpy instead.  With
    canonical=True both inputs are folded to revcomp-min form first
    (mixing plain and canonical spectra is then safe)."""
    import math

    if canonical:
        with _CanonizedInputs([path_a, path_b], sep) as folded:
            return similarity_spectra(folded[0], folded[1], sep=sep)

    sep_b = sep.encode()
    acc = _similarity_binary(path_a, path_b, sep_b)
    if acc is None:
        k = None
        da = db = shared = total_a = total_b = 0
        sum_min = sum_max = dot = norm_a = norm_b = 0.0
        ita = _sorted_lines(path_a, sep_b)
        itb = _sorted_lines(path_b, sep_b)
        a = next(ita, None)
        b = next(itb, None)
        if a is not None:
            k = len(a[0])
        elif b is not None:
            k = len(b[0])
        while a is not None or b is not None:
            if b is None or (a is not None and a[0] < b[0]):
                da += 1
                total_a += a[1]
                sum_max += a[1]
                norm_a += a[1] * a[1]
                a = next(ita, None)
            elif a is None or b[0] < a[0]:
                db += 1
                total_b += b[1]
                sum_max += b[1]
                norm_b += b[1] * b[1]
                b = next(itb, None)
            else:
                da += 1
                db += 1
                shared += 1
                total_a += a[1]
                total_b += b[1]
                sum_min += min(a[1], b[1])
                sum_max += max(a[1], b[1])
                dot += a[1] * b[1]
                norm_a += a[1] * a[1]
                norm_b += b[1] * b[1]
                a = next(ita, None)
                b = next(itb, None)
        acc = {
            "k": k,
            "distinct_a": da,
            "distinct_b": db,
            "shared": shared,
            "total_a": total_a,
            "total_b": total_b,
            "sum_min": sum_min,
            "sum_max": sum_max,
            "dot": dot,
            "norm_a": norm_a,
            "norm_b": norm_b,
        }

    da, db, shared = acc["distinct_a"], acc["distinct_b"], acc["shared"]
    union = da + db - shared
    j = shared / union if union else 0.0
    denom = math.sqrt(acc["norm_a"]) * math.sqrt(acc["norm_b"])
    k = acc["k"]
    if j > 0 and k:
        mash = max(0.0, -math.log(2 * j / (1 + j)) / k)
    else:
        mash = 0.0 if (da == 0 and db == 0) else 1.0
    return {
        "k": k if k else 0,
        "distinct_a": da,
        "distinct_b": db,
        "shared": shared,
        "union": union,
        "total_a": acc["total_a"],
        "total_b": acc["total_b"],
        "jaccard": j,
        "containment_a_in_b": shared / da if da else 0.0,
        "containment_b_in_a": shared / db if db else 0.0,
        "weighted_jaccard": (
            acc["sum_min"] / acc["sum_max"] if acc["sum_max"] else 0.0
        ),
        "cosine": acc["dot"] / denom if denom else 0.0,
        "mash_distance": mash,
    }


class _RevBytes:
    """bytes with reversed ordering (so ties prefer lexicographically
    SMALLER k-mers when evicting from the min-heap)."""

    __slots__ = ("b",)

    def __init__(self, b: bytes):
        self.b = b

    def __lt__(self, other):
        return self.b > other.b

    def __gt__(self, other):
        return self.b < other.b

    def __eq__(self, other):
        return self.b == other.b
