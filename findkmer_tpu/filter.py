"""Read filtering by spectrum membership (kmc_tools `filter` class).

`findkmer filter` keeps (or drops, --invert) reads whose k-mers hit a
spectrum: a read passes when at least `min_hits` of its valid k-mer
windows (or a `min_frac` fraction) are present in the given spectrum
file.  The tool-class envelope feature of KMC/kmc_tools (PAPERS.md
landscape); the reference has nothing comparable (SURVEY.md §2.1).

Two interchangeable scoring engines (filter_file `engine=`):
  * host — vectorized numpy / OpenMP C scan (src/native/encode.c
    fk_filter_hits): codes by rolling shift-or, one-probe bit-table
    prefilter, exact searchsorted on survivors.
  * device — sort-merge membership probe on the accelerator
    (filter_device.py): the
    counting engine's packed wire + window extraction, one unstable
    sort of [spectrum | windows] per batch.  `auto` picks it on a real
    accelerator.
FASTQ quality lines are preserved verbatim on output.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Iterator, Optional, Tuple

import numpy as np

from findkmer_tpu import spectra as _spectra

_CODE_LUT = np.full(256, 255, dtype=np.uint8)
for _i, _b in enumerate(b"ACGT"):
    _CODE_LUT[_b] = _i
    _CODE_LUT[_b + 32] = _i  # lowercase


def window_codes_host(seq: bytes, k: int):
    """(codes u64, valid bool) for every window of one sequence.

    codes[i] covers seq[i:i+k]; valid[i] is False when any base in the
    window is non-ACGT.  Vectorized shift-or (O(k) numpy passes)."""
    b = _CODE_LUT[np.frombuffer(seq, dtype=np.uint8)]
    n = b.size - k + 1
    if n <= 0:
        return np.empty(0, np.uint64), np.empty(0, bool)
    cbad = _cumsum01(b == 255)
    valid = cbad[k:] == cbad[:-k]  # flat monotone prefix = no bad base
    safe = np.where(b == 255, 0, b).astype(np.uint64)
    codes = np.zeros(n, np.uint64)
    for j in range(k):
        codes |= safe[j : j + n] << np.uint64(2 * (k - 1 - j))
    return codes, valid


_HASH_MULT = np.uint64(0x9E3779B97F4A7C15)


def _cumsum01(flags: np.ndarray) -> np.ndarray:
    """[0, cumsum(flags)] with the narrowest safe dtype, one buffer.

    flags is 0/1 per window; per-flush window counts are ~16.7M, so an
    int32 prefix sum halves the freshly-faulted bytes vs int64 — on a
    lazily-backed VM that faults fresh pages at ~0.02 GB/s (ROADMAP
    D10) the old concatenate+int64 pattern was the filter's hot loop."""
    dt = np.int32 if flags.size < 2**31 - 1 else np.int64
    out = np.empty(flags.size + 1, dt)
    out[0] = 0
    np.cumsum(flags, dtype=dt, out=out[1:])
    return out


def _read_spans(seqs, hit: np.ndarray, valid: np.ndarray, k: int):
    """Per-read (hits, valid windows) from per-window hit/valid arrays
    of the 'N'-joined stream (window i starts at joined position i).

    Shared by the host scorer (filter.py) and the device scorer
    (filter_device.py) so the two engines attribute identically."""
    n = len(seqs)
    hits = np.zeros(n, np.int64)
    windows = np.zeros(n, np.int64)
    size = int(valid.size)
    lens = np.fromiter((len(s) for s in seqs), np.int64, n)
    starts = np.zeros(n, np.int64)
    np.cumsum(lens[:-1] + 1, out=starts[1:])  # +1: the separator
    bounds = np.minimum(starts, size)
    seg = np.append(bounds, size)
    cv = _cumsum01(valid)
    ch = _cumsum01(hit)
    # windows starting within read i occupy [bounds[i], end_i) where
    # end_i = min(starts[i] + len_i, next bound)
    ends = np.minimum(np.minimum(starts + lens, seg[1:]), size)
    ends = np.maximum(ends, bounds)
    windows[:] = cv[ends] - cv[bounds]
    hits[:] = ch[ends] - ch[bounds]
    return hits, windows


@dataclass
class FilterSpec:
    """A loaded spectrum as a membership set (sorted u64 codes).

    Lookups go through a one-probe bit-table prefilter (>= 32 bits per
    entry, Fibonacci-hashed): a window that misses — the common case
    when filtering reads against a foreign spectrum — costs one
    vectorized gather; only prefilter survivors (true hits + <3%
    false positives) reach the exact searchsorted."""

    k: int
    codes: np.ndarray  # sorted uint64
    canonical: bool = False
    _bloom: Optional[np.ndarray] = None  # bool bit table
    _shift: int = 0

    def __post_init__(self):
        bits = 20
        while (1 << bits) < 32 * max(int(self.codes.size), 1):
            bits += 1
        bits = min(bits, 28)
        self._shift = 64 - bits
        self._bloom = np.zeros(1 << bits, bool)
        if self.codes.size:
            self._bloom[
                ((self.codes * _HASH_MULT) >> np.uint64(self._shift))
                .astype(np.int64)
            ] = True

    @classmethod
    def load(cls, path, sep: str = "\t", canonical: bool = False,
             min_count: int = 0, max_count: int = 0) -> "FilterSpec":
        spectra = _spectra
        sep_b = sep.encode()
        k = spectra._infer_k(path, sep_b)
        if k is None:
            raise ValueError(f"{path}: empty or malformed spectrum")
        parsed = (
            spectra._parse_binary(path, k, sep_b)
            if len(sep_b) == 1 else None
        )
        if parsed is None:
            from findkmer_tpu.ops.window import str_to_code

            d = spectra.read_spectrum(path, sep)
            try:
                codes = np.fromiter(
                    (str_to_code(km) for km in d), np.uint64, len(d)
                )
            except KeyError as e:
                raise ValueError(
                    f"{path}: non-ACGT k-mer in spectrum: {e}"
                ) from e
            counts = np.fromiter(d.values(), np.int64, len(d))
        else:
            codes, counts = parsed
        m = counts > 0
        codes, counts = codes[m], counts[m]
        if canonical:
            # fold BEFORE thresholding: a revcomp pair's counts sum in
            # canonical space, and the threshold must see the sum
            codes, counts = spectra.canonize_runs(codes, counts, k)
        m = np.ones(codes.size, bool)
        if min_count > 1:
            m &= counts >= min_count
        if max_count:
            m &= counts <= max_count
        codes = np.sort(codes[m])
        return cls(k=k, codes=codes, canonical=canonical)

    def hits(self, seq: bytes) -> Tuple[int, int]:
        """(hit windows, valid windows) of one read against the set."""
        h, w = self.hits_batch([seq])
        return int(h[0]), int(w[0])

    def hits_batch(self, seqs) -> Tuple[np.ndarray, np.ndarray]:
        """Per-read (hits, valid windows) for a LIST of reads, in one
        vectorized pass: reads are joined with a single 'N' separator,
        so windows spanning read boundaries are invalid by the normal
        masking rule — the same record-isolation trick as the counting
        pipeline (pipeline.py).  Uses the OpenMP C scan
        (src/native/encode.c fk_filter_hits) when built; numpy
        otherwise.  ~100x the per-read numpy cost on short-read FASTQ."""
        k = self.k
        n = len(seqs)
        hits = np.zeros(n, np.int64)
        windows = np.zeros(n, np.int64)
        if n == 0:
            return hits, windows
        from findkmer_tpu.io import native

        if native.available():
            lens = np.fromiter((len(s) for s in seqs), np.int64, n)
            starts = np.zeros(n, np.int64)
            np.cumsum(lens[:-1] + 1, out=starts[1:])  # +1: separator
            buf = np.frombuffer(b"N".join(seqs), np.uint8)
            return native.filter_hits(
                buf, starts, lens, k, self.canonical, self.codes,
                self._bloom, self._shift,
            )
        joined = b"N".join(seqs)
        codes, valid = window_codes_host(joined, k)
        if codes.size == 0:
            return hits, windows
        if self.canonical:
            codes = np.minimum(
                codes, _spectra.revcomp_codes_u64(codes, k)
            )
        hit = np.zeros(codes.size, bool)
        if self.codes.size:
            maybe = self._bloom[
                ((codes * _HASH_MULT) >> np.uint64(self._shift))
                .astype(np.int64)
            ]
            maybe &= valid
            cand = codes[maybe]
            if cand.size:
                idx = np.searchsorted(self.codes, cand)
                np.clip(idx, 0, self.codes.size - 1, out=idx)
                hit[maybe] = self.codes[idx] == cand
        # read i's windows START in [starts[i], starts[i] + len_i);
        # spanning windows are already invalid via the 'N' separator
        return _read_spans(seqs, hit, valid, k)


def _fastq_records_block(path) -> Iterator[Tuple[bytes, bytes]]:
    """(seq, verbatim record bytes) per FASTQ read, block-parsed.

    Newlines are located with one numpy pass PER 4 MB BLOCK (never
    rescanning carried bytes, so multi-block long-read records stay
    linear); strict 4-line records only — wrapped sequence/quality is
    refused, never silently misparsed — with blank lines tolerated
    where a HEADER is expected (between records; matches
    io/fastq.FastqReader).  A blank line in the sequence position is a
    legitimate empty read."""
    from findkmer_tpu.io.fasta import open_maybe_gzip

    f, own = open_maybe_gzip(path)
    try:
        parts: list = []       # unconsumed byte chunks, in order
        nls: list = []         # their newline positions (absolute)
        base = 0               # total unconsumed bytes
        n_nl = 0
        eof = False
        while True:
            if not eof:
                block = f.read(1 << 22)
                if block:
                    arr = np.frombuffer(block, np.uint8)
                    nl_new = np.flatnonzero(arr == 10).astype(np.int64)
                    nl_new += base
                    parts.append(block)
                    nls.append(nl_new)
                    base += len(block)
                    n_nl += nl_new.size
                else:
                    eof = True
                    if base and not parts[-1].endswith(b"\n"):
                        parts.append(b"\n")  # unterminated final line
                        nls.append(np.array([base], np.int64))
                        base += 1
                        n_nl += 1
            if base == 0:
                return
            if n_nl < 4 and not eof:
                continue  # no complete record can exist yet
            data = b"".join(parts)
            nl = (
                np.concatenate(nls) if len(nls) > 1
                else (nls[0] if nls else np.empty(0, np.int64))
            )

            def line_start(i: int) -> int:
                return 0 if i == 0 else int(nl[i - 1]) + 1

            li = 0
            consumed = 0
            # fast path: when every 4-line group in this flush is a
            # clean strict record (vectorized '@'/'+' check), group
            # without the per-line walk; any blank/odd line falls to
            # the walking loop below, which tolerates blanks at header
            # positions and raises on true multi-line FASTQ
            nrec = nl.size // 4
            if nrec:
                arr = np.frombuffer(data, np.uint8)
                starts = np.empty(4 * nrec, np.int64)
                starts[0] = 0
                starts[1:] = nl[: 4 * nrec - 1] + 1
                if (
                    (arr[starts[0::4]] == 0x40).all()
                    and (arr[starts[2::4]] == 0x2B).all()
                ):
                    seq_s = starts[1::4]
                    seq_e = nl[1::4][:nrec]
                    rec_s = starts[0::4]
                    rec_e = nl[3::4][:nrec] + 1
                    for i in range(nrec):
                        s1, e1 = int(seq_s[i]), int(seq_e[i])
                        if e1 > s1 and data[e1 - 1] == 0x0D:  # CRLF
                            e1 -= 1
                        yield (
                            data[s1:e1],
                            data[int(rec_s[i]) : int(rec_e[i])],
                        )
                    li = 4 * nrec
                    consumed = int(rec_e[-1])
            while True:
                # skip blank lines where a header is expected
                while li < nl.size:
                    s0 = line_start(li)
                    e0 = int(nl[li])
                    if e0 - s0 == 0 or (
                        e0 - s0 == 1 and data[s0] == 0x0D
                    ):
                        li += 1
                        consumed = e0 + 1
                        continue
                    break
                if li + 4 > nl.size:
                    break  # incomplete record: carry the tail
                s0 = line_start(li)
                s2 = line_start(li + 2)
                if data[s0] != 0x40 or data[s2] != 0x2B:
                    raise ValueError(
                        f"{path}: multi-line FASTQ is not supported "
                        "(expected @header/seq/+/quality groups)"
                    )
                s1 = line_start(li + 1)
                e1 = int(nl[li + 1])
                if e1 > s1 and data[e1 - 1] == 0x0D:  # CRLF
                    e1 -= 1
                e3 = int(nl[li + 3]) + 1
                yield data[s1:e1], data[s0:e3]
                li += 4
                consumed = e3
            if eof:
                # strip ONLY newline characters: a space-only trailing
                # line is malformed to the strict line reader
                # (FastqReader), and the flows must agree on
                # accept/reject
                if data[consumed:].strip(b"\r\n"):
                    raise ValueError(f"{path}: truncated FASTQ record")
                return
            rem = data[consumed:]
            parts = [rem] if rem else []
            nls = [nl[li:] - consumed] if li < nl.size else []
            base = len(rem)
            n_nl = nl.size - li
    finally:
        if own:
            f.close()


def _fastq_blocks(path, block_bytes: int = 1 << 22):
    """Offsets-based zero-copy FASTQ block reader (C record scanner,
    src/native/encode.c fk_fastq_scan): yields (data uint8 array,
    seq_start, seq_end, rec_start, rec_end) per ~4 MB block — no
    per-read byte slices, no per-line Python.  Same record contract as
    _fastq_records_block (strict 4-line, blank lines at header
    positions, CRLF-stripped sequence spans, errors on wrapped FASTQ);
    the two parsers are cross-diffed in tests/test_filter.py."""
    from findkmer_tpu.io import native
    from findkmer_tpu.io.fasta import open_maybe_gzip

    f, own = open_maybe_gzip(path)
    try:
        tail = b""
        eof = False
        while True:
            chunks = [tail] if tail else []
            size = len(tail)
            while size < block_bytes and not eof:
                b = f.read(block_bytes)
                if not b:
                    eof = True
                    break
                chunks.append(b)
                size += len(b)
            if eof and size and not (chunks[-1].endswith(b"\n")):
                chunks.append(b"\n")  # unterminated final line
            data = b"".join(chunks)
            if not data:
                return
            buf = np.frombuffer(data, np.uint8)
            seq_s, seq_e, rec_s, rec_e, consumed, err = (
                native.fastq_scan(buf)
            )
            if seq_s.size:
                yield buf, seq_s, seq_e, rec_s, rec_e
            if err:
                raise ValueError(
                    f"{path}: multi-line FASTQ is not supported "
                    "(expected @header/seq/+/quality groups)"
                )
            if eof:
                # strip ONLY newline characters: a space-only trailing
                # line is malformed to the strict line reader
                # (FastqReader), and the flows must agree on
                # accept/reject
                if data[consumed:].strip(b"\r\n"):
                    raise ValueError(f"{path}: truncated FASTQ record")
                return
            if consumed == 0 and len(data) >= block_bytes:
                # a single record larger than the block: widen and retry
                tail = data
                block_bytes *= 2
                continue
            tail = data[consumed:]
    finally:
        if own:
            f.close()


def _records_with_raw(path, fmt: str) -> Iterator[Tuple[bytes, bytes]]:
    """Yield (sequence_bytes, verbatim_record_bytes) per read.

    FASTQ: strict 4-line groups, quality preserved verbatim; FASTA:
    records re-emitted as '>header\\nseq\\n' (one line)."""
    from findkmer_tpu.io.fasta import FastaReader, open_maybe_gzip
    from findkmer_tpu.io.fastq import sniff_format

    if fmt == "auto":
        fmt = sniff_format(path)
    if fmt in ("sam", "bam"):
        raise SystemExit(
            "findkmer filter reads FASTA/FASTQ only (SAM/BAM records "
            "cannot be re-emitted verbatim); convert first"
        )
    if fmt == "fastq":
        yield from _fastq_records_block(path)
        return
    with FastaReader(path) as reader:
        for header, seq in reader.records():
            raw = b">" + header.encode("ascii", "replace") + b"\n" + seq \
                + b"\n"
            yield seq, raw


def _resolve_engine(engine: str) -> str:
    """auto -> the native host C scan when built, device only as the
    accelerator-backed fallback, numpy host otherwise.

    With the offsets flow the OpenMP binary-search scan beat the device
    engine end to end on the previous accelerator, and it scales with
    host cores while the device path pays H2D per read; the comparison
    on the H100 is ROADMAP S8.  The device engine stays as the `auto` pick
    when the C library is unavailable (the numpy fallback scorer is
    the slowest path) and as an explicit `--engine device` choice."""
    if engine != "auto":
        return engine
    from .io import native as _nat

    if _nat.available():
        return "host"
    try:
        import jax

        return "device" if jax.default_backend() not in ("cpu",) \
            else "host"
    except Exception:
        return "host"


def _pipeline_depth() -> int:
    """In-flight device flushes (cross-flush pipelining depth).

    0 = synchronous (finish each flush before reading on)."""
    import os

    try:
        return max(0, int(os.environ.get("FINDKMER_FILTER_DEPTH", "2")))
    except ValueError:
        return 2


def _keep_mask(hits, wins, min_hits, min_frac, invert):
    """Vectorized pass/keep rule, float-identical to the scalar one
    (h/w >= frac via the same IEEE double division)."""
    ok = hits >= min_hits
    if min_frac is not None:
        nz = wins > 0
        frac_ok = np.zeros(ok.shape, bool)
        frac_ok[nz] = (hits[nz] / wins[nz]) >= min_frac
        ok &= frac_ok
    return ok != invert


def _emit_records(out_f, data, rec_s, rec_e, keep) -> int:
    """Write kept records as COALESCED spans of the block buffer:
    adjacent kept records merge into one write (the emit leg of the
    offsets flow — per-run syscalls instead of per-read)."""
    idx = np.flatnonzero(keep)
    if idx.size == 0:
        return 0
    mv = memoryview(data)
    brk = np.flatnonzero(rec_s[idx[1:]] != rec_e[idx[:-1]])
    run_a = np.concatenate(([0], brk + 1))
    run_b = np.concatenate((brk, [idx.size - 1]))
    for a, b in zip(run_a, run_b):
        out_f.write(mv[int(rec_s[idx[a]]) : int(rec_e[idx[b]])])
    return int(idx.size)


def _scored_segments(path, spec, engine, scorer=None):
    """Offsets-flow scoring stream: yields (hits, wins, data, rec_s,
    rec_e) per SEGMENT (one scanned block), in input order.  Reads are
    scored in place in the block buffer (host: C scan at block offsets;
    device: C gather-encode into the packed wire), with the device
    engine keeping FINDKMER_FILTER_DEPTH flushes in flight.  Shared by
    the single-end and paired offsets flows; `scorer` lets paired
    callers share one DeviceFilter (one member table on device) across
    both mate streams."""
    from collections import deque

    from findkmer_tpu.io import native

    k = spec.k
    if engine == "device":
        if scorer is None:
            from findkmer_tpu.filter_device import DeviceFilter

            scorer = DeviceFilter(spec)
        batch_bytes = scorer.need
        depth = _pipeline_depth()
    else:
        scorer = None
        batch_bytes = 8 << 20
        depth = 0
    segs: list = []        # (data, seq_s, joined_s, lens, rec_s, rec_e)
    nbases = nreads = 0
    pending: deque = deque()
    import os as _os

    block_bytes = int(
        _os.environ.get("FINDKMER_FILTER_BLOCK", str(1 << 22))
    )  # test hook: small blocks force multi-segment flushes

    def score_host(segs_):
        for data, ss, js, lens, rs, re_ in segs_:
            h, w = native.filter_hits(
                data, ss, lens, k, spec.canonical, spec.codes,
                spec._bloom, spec._shift,
            )
            yield (h, w, data, rs, re_)

    def drain_one():
        p, segs_ = pending.popleft()
        hits, wins = scorer.finish(p)
        off = 0
        for data, ss, js, lens, rs, re_ in segs_:
            n = ss.size
            yield (hits[off : off + n], wins[off : off + n],
                   data, rs, re_)
            off += n

    def flush():
        nonlocal segs, nbases, nreads
        if not segs:
            return
        if depth:
            pending.append((scorer.begin_offsets(segs, nbases, nreads),
                            segs))
            while len(pending) > depth:
                yield from drain_one()
        else:
            yield from score_host(segs)
        segs = []
        nbases = nreads = 0

    for data, seq_s, seq_e, rec_s, rec_e in _fastq_blocks(
        path, block_bytes=block_bytes
    ):
        lens = seq_e - seq_s
        n = int(seq_s.size)
        bases = int(lens.sum())
        if segs and nbases + nreads + bases + n > batch_bytes:
            yield from flush()
        # joined-stream starts of this block's reads (one separator
        # slot between consecutive reads, across segment joints too):
        # current joined length is nbases + nreads - 1, so the next
        # read starts at nbases + nreads (also right when empty)
        js = np.empty(n, np.int64)
        js[0] = nbases + nreads
        np.cumsum(lens[:-1] + 1, out=js[1:])
        if n > 1:
            js[1:] += js[0]
        segs.append((data, seq_s, js, lens, rec_s, rec_e))
        nbases += bases
        nreads += n
    yield from flush()
    while pending:
        yield from drain_one()


def _filter_fastq_offsets(
    path, out_f, spec, *, min_hits, min_frac, invert, engine
) -> Tuple[int, int]:
    """Single-end FASTQ filtering on the offsets-based zero-copy flow:
    the C record scanner (_fastq_blocks) produces per-block offset
    arrays, reads are scored IN PLACE in the block buffer
    (_scored_segments), and kept records are emitted as coalesced block
    spans.  No per-read Python objects anywhere — the parse+emit
    residual of the list-based flow collapses to the per-block calls."""
    kept = seen = 0
    for h, w, data, rs, re_ in _scored_segments(path, spec, engine):
        seen += int(h.size)
        keep = _keep_mask(h, w, min_hits, min_frac, invert)
        kept += _emit_records(out_f, data, rs, re_, keep)
    return kept, seen


def _filter_fastq_offsets_paired(
    path1, path2, out1_f, out2_f, spec, *,
    min_hits, min_frac, invert, engine, pair_mode,
) -> Tuple[int, int]:
    """Paired-end offsets flow: each mate file runs its own
    _scored_segments stream (sharing ONE device scorer); the pair
    decision zips the two scored streams in aligned chunks and emits
    kept pairs as coalesced spans per side.  Same semantics as
    filter_file_paired's list flow (pairs kept/dropped together,
    outputs index-synchronized)."""
    scorer = None
    if engine == "device":
        from findkmer_tpu.filter_device import DeviceFilter

        scorer = DeviceFilter(spec)
    s1 = iter(_scored_segments(path1, spec, engine, scorer=scorer))
    s2 = iter(_scored_segments(path2, spec, engine, scorer=scorer))
    kept = seen = 0
    b1 = b2 = None  # (h, w, data, rs, re_), consumed offset
    o1 = o2 = 0

    def passes(h, w):
        # per-mate pass rule = _keep_mask before the pair-level invert
        return _keep_mask(h, w, min_hits, min_frac, False)

    while True:
        if b1 is None or o1 >= b1[0].size:
            b1, o1 = next(s1, None), 0
        if b2 is None or o2 >= b2[0].size:
            b2, o2 = next(s2, None), 0
        if b1 is None or b2 is None:
            if (b1 is None) != (b2 is None):
                raise ValueError(
                    f"paired inputs differ in read count ({path1} vs "
                    f"{path2}); pair {seen + 1} is unmatched"
                )
            break
        take = min(b1[0].size - o1, b2[0].size - o2)
        p1 = passes(b1[0][o1 : o1 + take], b1[1][o1 : o1 + take])
        p2 = passes(b2[0][o2 : o2 + take], b2[1][o2 : o2 + take])
        ok = (p1 | p2) if pair_mode == "any" else (p1 & p2)
        keep = ok != invert
        kept += _emit_records(
            out1_f, b1[2], b1[3][o1 : o1 + take], b1[4][o1 : o1 + take],
            keep,
        )
        _emit_records(
            out2_f, b2[2], b2[3][o2 : o2 + take], b2[4][o2 : o2 + take],
            keep,
        )
        seen += take
        o1 += take
        o2 += take
    return kept, seen


def filter_file(
    path,
    out_f,
    spec: FilterSpec,
    *,
    fmt: str = "auto",
    min_hits: int = 1,
    min_frac: Optional[float] = None,
    invert: bool = False,
    engine: str = "auto",
) -> Tuple[int, int]:
    """Stream reads from `path`, write passing records to out_f.

    A read passes when hits >= min_hits AND (min_frac is None or
    hits/valid_windows >= min_frac); --invert keeps the complement.
    Reads are scored in multi-MB batches (FilterSpec.hits_batch) so the
    per-read Python cost is one list append, not a numpy pipeline.
    engine: "host" (OpenMP C scan / numpy), "device" (sort-merge
    membership on the accelerator, filter_device.py), or "auto" (the native host scan
    when built, else device on a real accelerator — _resolve_engine).
    Both engines are bit-for-bit interchangeable.
    Returns (reads kept, reads seen).

    FASTQ inputs take the offsets-based zero-copy flow when the native
    library is built (_filter_fastq_offsets: C record scan, in-place
    scoring, coalesced emit; FINDKMER_FILTER_FAST=0 forces the
    list-based flow — both are byte-identical, tests/test_filter.py)."""
    import os

    from findkmer_tpu.io import native as _native
    from findkmer_tpu.io.fastq import sniff_format

    engine = _resolve_engine(engine)
    if fmt == "auto":
        fmt = sniff_format(path)
    if (
        fmt == "fastq"
        and _native.available()
        and os.environ.get("FINDKMER_FILTER_FAST", "1") == "1"
    ):
        return _filter_fastq_offsets(
            path, out_f, spec, min_hits=min_hits, min_frac=min_frac,
            invert=invert, engine=engine,
        )
    if engine == "device":
        from findkmer_tpu.filter_device import DeviceFilter

        scorer = DeviceFilter(spec)
        # one device batch per flush: the joined stream (bases +
        # separators) must stay <= scorer.need or _dispatch_bitmaps
        # pays a SECOND full sort + H2D that is ~94% padding
        batch_bytes = scorer.need
        depth = _pipeline_depth()  # in-flight flushes
    elif engine == "host":
        scorer = spec
        batch_bytes = 8 << 20
        depth = 0
    else:
        raise ValueError(f"unknown filter engine {engine!r}")
    kept = seen = 0
    batch_seqs: list = []
    batch_raws: list = []
    nbytes = 0
    from collections import deque

    pending: deque = deque()  # device engine: begin()s awaiting finish

    def emit(hits, windows, raws):
        nonlocal kept
        for raw, h, w in zip(raws, hits, windows):
            ok = h >= min_hits
            if ok and min_frac is not None:
                ok = w > 0 and h / w >= min_frac
            if bool(ok) != invert:
                out_f.write(raw)
                kept += 1

    def drain_one():
        p, raws = pending.popleft()
        emit(*scorer.finish(p), raws)

    def flush():
        nonlocal batch_seqs, batch_raws, nbytes
        if not batch_seqs:
            return
        if depth:
            # dispatch this flush's device work and KEEP READING: its
            # D2H + attribution happen while the device sorts the next
            # flush
            pending.append((scorer.begin(batch_seqs), batch_raws))
            batch_seqs, batch_raws = [], []  # moved into pending
            while len(pending) > depth:
                drain_one()
        else:
            emit(*scorer.hits_batch(batch_seqs), batch_raws)
            batch_seqs.clear()
            batch_raws.clear()
        nbytes = 0

    for seq, raw in _records_with_raw(path, fmt):
        seen += 1
        # flush BEFORE appending once this read would overflow the
        # batch (joined size = bases + one 'N' separator per joint), so
        # a flush's joined stream never exceeds batch_bytes
        if batch_seqs and nbytes + len(batch_seqs) + len(seq) > batch_bytes:
            flush()
        batch_seqs.append(seq)
        batch_raws.append(raw)
        nbytes += len(seq)
        if len(batch_seqs) >= 65536:
            flush()
    flush()
    while pending:
        drain_one()
    return kept, seen


def filter_file_paired(
    path1,
    path2,
    out1_f,
    out2_f,
    spec: FilterSpec,
    *,
    fmt: str = "auto",
    min_hits: int = 1,
    min_frac: Optional[float] = None,
    invert: bool = False,
    engine: str = "auto",
    pair_mode: str = "any",
) -> Tuple[int, int]:
    """Paired-end filtering: R1/R2 streamed in lockstep, PAIRS kept or
    dropped together (a kept pair writes mate 1 to out1_f and mate 2 to
    out2_f, so the outputs stay index-synchronized — the BBDuk/seqkit
    paired contract).

    pair_mode: "any" keeps the pair when EITHER mate passes the
    min_hits/min_frac rule (the usual keep-if-matches semantics);
    "both" requires both mates to pass.  --invert keeps the complement
    of the pair-level decision.  Returns (pairs kept, pairs seen);
    raises on files with different read counts."""
    if pair_mode not in ("any", "both"):
        raise ValueError(f"unknown pair mode {pair_mode!r}")
    import os

    from findkmer_tpu.io import native as _native
    from findkmer_tpu.io.fastq import sniff_format

    engine = _resolve_engine(engine)
    if fmt == "auto":
        fmt1, fmt2 = sniff_format(path1), sniff_format(path2)
        fmt = fmt1 if fmt1 == fmt2 else "auto"
    if (
        fmt == "fastq"
        and _native.available()
        and os.environ.get("FINDKMER_FILTER_FAST", "1") == "1"
    ):
        return _filter_fastq_offsets_paired(
            path1, path2, out1_f, out2_f, spec, min_hits=min_hits,
            min_frac=min_frac, invert=invert, engine=engine,
            pair_mode=pair_mode,
        )
    if engine == "device":
        from findkmer_tpu.filter_device import DeviceFilter

        scorer = DeviceFilter(spec)
        batch_bytes = scorer.need  # one device batch per flush (above)
        depth = _pipeline_depth()
    else:
        scorer = spec
        batch_bytes = 8 << 20
        depth = 0
    kept = seen = 0
    b_seqs: list = []   # interleaved mate1, mate2, mate1, ...
    b_raws: list = []
    nbytes = 0
    from collections import deque

    pending: deque = deque()

    def passes(h, w):
        ok = h >= min_hits
        if ok and min_frac is not None:
            ok = w > 0 and h / w >= min_frac
        return bool(ok)

    def emit(hits, windows, raws):
        nonlocal kept
        for i in range(0, len(raws), 2):
            p1 = passes(hits[i], windows[i])
            p2 = passes(hits[i + 1], windows[i + 1])
            ok = (p1 or p2) if pair_mode == "any" else (p1 and p2)
            if ok != invert:
                out1_f.write(raws[i])
                out2_f.write(raws[i + 1])
                kept += 1

    def drain_one():
        p, raws = pending.popleft()
        emit(*scorer.finish(p), raws)

    def flush():
        nonlocal b_seqs, b_raws, nbytes
        if not b_seqs:
            return
        if depth:
            pending.append((scorer.begin(b_seqs), b_raws))
            b_seqs, b_raws = [], []
            while len(pending) > depth:
                drain_one()
        else:
            emit(*scorer.hits_batch(b_seqs), b_raws)
            b_seqs.clear()
            b_raws.clear()
        nbytes = 0

    it1 = _records_with_raw(path1, fmt)
    it2 = _records_with_raw(path2, fmt)
    while True:
        r1 = next(it1, None)
        r2 = next(it2, None)
        if r1 is None and r2 is None:
            break
        if r1 is None or r2 is None:
            raise ValueError(
                f"paired inputs differ in read count ({path1} vs "
                f"{path2}); pair {seen + 1} is unmatched"
            )
        seen += 1
        pair_bases = len(r1[0]) + len(r2[0])
        # flush before the pair that would overflow one device batch
        # (joined size = bases + separators); pairs are never split
        if b_seqs and nbytes + len(b_seqs) + 1 + pair_bases > batch_bytes:
            flush()
        for seq, raw in (r1, r2):
            b_seqs.append(seq)
            b_raws.append(raw)
            nbytes += len(seq)
        if len(b_seqs) >= 65536:
            flush()
    flush()
    while pending:
        drain_one()
    return kept, seen
