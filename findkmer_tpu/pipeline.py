"""Streaming batch pipeline: FASTA -> encoded rows -> device batches.

Replaces the reference's fgetc-driven main loop (SURVEY.md §3.1 E1) with a
batched, double-buffered stream (SURVEY.md §2.3 N8):

  1. io.fasta streams record chunks; io.encode maps them to uint8 codes.
  2. Records are joined into one virtual code stream with a single INVALID
     separator between records — any window spanning a record boundary
     contains the separator and is masked out, so record isolation
     (SURVEY.md §0.1) falls out of N-masking with zero special cases.
  3. The virtual stream is cut into rows of L owned codes, each prefixed
     with the previous row's last k-1 codes (the halo).  A window ends in
     exactly one row, so every window is counted exactly once across chunk
     joints (SURVEY.md §5 long-context / SP analog).
  4. Rows are packed into fixed (B, L+k-1) batches — static shapes, one jit
     compilation — and fed to the counter with the next batch's H2D
     transfer in flight (prefetch; JAX dispatch is async).

The row construction is one numpy sliding_window_view per batch: no Python
per-base work anywhere on the hot path.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Iterator, Optional

import numpy as np

import jax

from findkmer_tpu.config import Config
from findkmer_tpu.io.encode import INVALID, encode_bytes
from findkmer_tpu.io.fasta import FastaReader
from findkmer_tpu.utils.malloc_tuning import tune_for_streaming

tune_for_streaming()  # keep big freed buffers on the heap (module doc)


@dataclass
class StreamStats:
    """Running observability counters (SURVEY.md §5 metrics)."""

    records: int = 0
    bases: int = 0           # sequence bytes seen (excl. separators)
    valid_bases: int = 0     # ACGT bases
    batches: int = 0
    rows: int = 0
    h2d_bytes: int = 0

    def as_dict(self):
        return dataclasses.asdict(self)


def code_stream(
    reader: FastaReader,
    *,
    prefer_native: bool = True,
    stats: Optional[StreamStats] = None,
) -> Iterator[np.ndarray]:
    """Encoded code chunks with one INVALID separator after each record.

    This is the plain (non-fused) encode path; the production fused
    strip+encode-into-work-buffer flow is _batches_fused."""
    sep = np.array([INVALID], dtype=np.uint8)
    for chunk in reader.chunks():
        if chunk.data:
            codes = encode_bytes(chunk.data, prefer_native=prefer_native)
            if stats is not None:
                stats.bases += codes.size
                stats.valid_bases += int(np.count_nonzero(codes < 4))
            yield codes
        if chunk.final:
            if stats is not None:
                stats.records += 1
            yield sep


class _BatchEmitter:
    """The shared work buffer + batch materializer.

    One persistent `work` buffer holds the flat stream window; each batch
    is a single strided copy (or fused C pack) out of it.  The output
    array is freshly allocated per batch (it may alias into a
    still-in-flight device_put, so reuse would race the H2D DMA) but
    utils.malloc_tuning keeps glibc from munmapping freed big buffers, so
    the pages stay warm — a lazily-backed VM faults fresh pages at
    ~0.02 GB/s (measured on the previous host VM; ROADMAP D10) and per-batch mmap churn dominated the host
    pipeline before this.
    """

    def __init__(self, cfg: Config, stats: Optional[StreamStats]):
        k, L, B = cfg.k, cfg.chunk_len, cfg.batch_rows
        self.R = L + k - 1
        self.L, self.B = L, B
        self.need = B * L  # owned codes per batch
        self.halo = k - 1
        self.work = np.full(self.halo + self.need, INVALID, dtype=np.uint8)
        self.filled = 0  # owned codes currently in work[halo:]
        self.stats = stats
        self.pack = cfg.packed_h2d
        # tail shrink: an input that ends before the FIRST full batch
        # emits a ladder-rung-sized batch instead of padding to the full
        # (B, L) shape — at batch_rows=1024 a 50 kb file would otherwise
        # pay a 67 Mbase-shaped extraction + 2-batch raw buffers (74 s
        # on CPU).  Only the first batch (no new shapes in steady-state
        # streaming, where the padded tail is one batch among many) and
        # only single-device (the dist paths derive their jit shapes
        # from cfg.batch_rows and require full batches).  Multi-file
        # streams build one emitter per file, so each sub-batch-size
        # file can shrink — the {1,1.5}x2^i rung ladder bounds the
        # distinct compiled shapes to ~2*log2(B) total, persistently
        # cached.
        self._emitted = 0
        self._shrink_ok = cfg.devices == 1
        if self.pack:
            from findkmer_tpu.io import native as native_mod

            self._native_pack = native_mod.available()
            self._native_mod = native_mod
            self.R8 = (self.R + 7) // 8 * 8

    def emit(self, rows: Optional[int] = None):
        work, L, R = self.work, self.L, self.R
        B = self.B if rows is None else rows
        need, halo, stats = B * L, self.halo, self.stats
        self.filled = 0
        self._emitted += 1
        if stats is not None:
            stats.batches += 1
            stats.rows += B
        if self.pack:
            # 2-bit + validity-bit device format: 0.375 B/base on the
            # wire (H2D bandwidth bounds e2e throughput here)
            if self._native_pack:
                packed, validbits = self._native_mod.pack_rows(work, B, L, R)
            else:
                packed, validbits = _numpy_pack_rows(work, B, L, R, self.R8)
            if halo:
                work[:halo] = work[need : need + halo]
            if stats is not None:
                stats.h2d_bytes += packed.nbytes + validbits.nbytes
            return packed, validbits
        # raw byte rows: row i = work[i*L : i*L + R].  Copy the owned
        # region as one contiguous reshape (row-wise memcpy; the naive
        # overlapping strided copy ran at 80 MB/s) and fix up the k-1
        # halo columns with a tiny strided copy.
        out = np.empty((B, R), dtype=np.uint8)
        out[:, halo:] = work[halo : halo + need].reshape(B, L)
        if halo:
            out[:, :halo] = np.lib.stride_tricks.as_strided(
                work, shape=(B, halo), strides=(L, 1)
            )
            work[:halo] = work[need : need + halo]  # next batch's halo
        if stats is not None:
            stats.h2d_bytes += out.nbytes
        return out

    def finish(self):
        """Flush the partial tail batch (if any).

        A first-and-only partial batch shrinks to the smallest
        {1,1.5}x2^i ladder rung of rows covering the fill (see
        __init__); later tails keep the full compiled shape."""
        if not self.filled:
            return []
        if self._shrink_ok and self._emitted == 0:
            from findkmer_tpu.ops import sparse as sparse_ops

            rows = min(
                self.B,
                sparse_ops.ladder(-(-self.filled // self.L), floor=1),
            )
            self.work[self.halo + self.filled : self.halo + rows * self.L] = (
                INVALID
            )
            return [self.emit(rows)]
        self.work[self.halo + self.filled :] = INVALID
        return [self.emit()]


def batches_from_codes(
    codes: Iterator[np.ndarray],
    cfg: Config,
    *,
    stats: Optional[StreamStats] = None,
) -> Iterator[np.ndarray]:
    """Cut a virtual code stream into (B, L+k-1) uint8 row batches.

    Row i of a batch covers L owned stream positions plus the k-1 halo
    codes that precede them (INVALID-filled at stream start).  The final
    batch is INVALID-padded to full shape (static shapes for jit,
    SURVEY.md §7 hard part 3).
    """
    em = _BatchEmitter(cfg, stats)
    halo, need = em.halo, em.need
    for arr in codes:
        pos = 0
        n = arr.size
        while n - pos >= need - em.filled:
            take = need - em.filled
            em.work[halo + em.filled : halo + need] = arr[pos : pos + take]
            pos += take
            yield em.emit()
        rem = n - pos
        if rem:
            em.work[halo + em.filled : halo + em.filled + rem] = arr[pos:]
            em.filled += rem
    yield from em.finish()


def _batches_fused(
    reader, cfg: Config, *, stats: Optional[StreamStats] = None
) -> Iterator[np.ndarray]:
    """Fused reader->work-buffer batching: the C strip+encode pass writes
    DIRECTLY into the batch work buffer (no intermediate codes array, no
    second copy).  Requires the native encoder; reader chunks must carry
    raw bytes (FastaReader strip_ws=False, or FASTQ lines).

    Output is identical to batches_from_codes(code_stream(...)) — the
    oracle CLI tests cover both paths.
    """
    from findkmer_tpu.io import native as native_mod

    em = _BatchEmitter(cfg, stats)
    halo, need = em.halo, em.need
    for chunk in reader.chunks():
        data = chunk.data
        if data:
            buf = np.frombuffer(data, dtype=np.uint8)
            pos = 0
            n = buf.size
            while pos < n:
                space = need - em.filled
                take = min(n - pos, space)
                m = native_mod.encode_compact_into(
                    buf[pos : pos + take], em.work, halo + em.filled
                )
                if stats is not None:
                    stats.bases += m
                    stats.valid_bases += native_mod.count_acgt(
                        em.work, halo + em.filled, m
                    )
                em.filled += m
                pos += take
                if em.filled >= need:
                    yield em.emit()
        if chunk.final:
            if stats is not None:
                stats.records += 1
            # one INVALID separator isolates records (windows spanning
            # it are masked out); filled < need holds here because the
            # data loop emits whenever the buffer fills
            em.work[halo + em.filled] = INVALID
            em.filled += 1
            if em.filled >= need:
                yield em.emit()
    yield from em.finish()


def _numpy_pack_rows(work, B, L, R, R8):
    """Vectorized fallback for native.pack_rows (same output layout)."""
    rows = np.full((B, R8), INVALID, dtype=np.uint8)
    # build rows via the same contiguous + halo trick
    halo = R - L
    rows[:, halo:R] = work[halo : halo + B * L].reshape(B, L)
    if halo:
        rows[:, :halo] = np.lib.stride_tricks.as_strided(
            work, shape=(B, halo), strides=(L, 1)
        )
    valid = rows < 4
    safe = np.where(valid, rows, 0).astype(np.uint8)
    # MSB-first bit order (big-endian 2-bit stream; see encode.c)
    packed = (
        (safe[:, 0::4] << 6)
        | (safe[:, 1::4] << 4)
        | (safe[:, 2::4] << 2)
        | safe[:, 3::4]
    ).astype(np.uint8)
    validbits = np.packbits(valid, axis=1, bitorder="big")
    return packed, validbits


def _fastq_code_stream(
    path, *, stats: Optional[StreamStats] = None
) -> Iterator[np.ndarray]:
    """Offsets-based zero-copy FASTQ -> code stream (counting-side twin
    of the filter's fast flow): the C record scanner
    (filter._fastq_blocks / fk_fastq_scan) yields per-block offset
    arrays and fk_filter_gather_prepare LUT-encodes every read straight
    into one INVALID-prefilled code buffer, separators already in
    place — no per-read Python objects, no per-line loop.  Replaces the
    FastqReader.chunks() parse that bounded FASTQ counting end to end."""
    from findkmer_tpu.filter import _fastq_blocks
    from findkmer_tpu.io import native as native_mod

    for data, seq_s, seq_e, rec_s, rec_e in _fastq_blocks(path):
        lens = seq_e - seq_s
        n = int(seq_s.size)
        js = np.empty(n, np.int64)
        js[0] = 0
        np.cumsum(lens[:-1] + 1, out=js[1:])
        total = int(lens.sum()) + n  # one separator after EACH record
        buf = np.full(total, INVALID, np.uint8)
        native_mod.filter_gather_prepare(data, seq_s, js, lens, buf)
        if stats is not None:
            stats.records += n
            stats.bases += total - n
            stats.valid_bases += native_mod.count_acgt(buf, 0, total)
        yield buf


def _fastq_fast_ok(path, cfg: Config) -> bool:
    """Gate for the offsets-based FASTQ counting path: real file path,
    FASTQ format, no quality masking, native library built."""
    import os

    from findkmer_tpu.io import native as native_mod

    if path == "-" or cfg.min_qual > 0 or not cfg.use_native_encode:
        return False
    if os.environ.get("FINDKMER_FASTQ_FAST", "1") != "1":
        return False
    if not native_mod.available():
        return False
    if cfg.input_format == "fastq":
        return True
    if cfg.input_format != "auto":
        return False
    from findkmer_tpu.io.fastq import sniff_format

    try:
        return sniff_format(path) == "fastq"
    except Exception:
        return False


def batches_from_file(
    path, cfg: Config, *, stats: Optional[StreamStats] = None
) -> Iterator[np.ndarray]:
    if _fastq_fast_ok(path, cfg):
        yield from batches_from_codes(
            _fastq_code_stream(path, stats=stats), cfg, stats=stats
        )
        return
    reader, fused = _open_reader(path, cfg)
    try:
        yield from _batches_from_reader(reader, fused, cfg, stats=stats)
    finally:
        reader.close()


class _ChunkIterReader:
    """Reader adapter over an in-hand chunk iterator (per-record slicing)."""

    def __init__(self, chunks_iter):
        self._it = chunks_iter

    def chunks(self):
        return self._it


def _open_reader(path, cfg: Config):
    """(reader, fused) for one input path — the shared front of
    batches_from_file and per_record_spectra."""
    from findkmer_tpu.io import native as native_mod
    from findkmer_tpu.io.fastq import FastqReader, sniff_format, sniff_head
    from findkmer_tpu.io.sam import BamReader, SamReader

    fmt = cfg.input_format
    fused = cfg.use_native_encode and native_mod.available()
    if path == "-":
        # stdin: one non-seekable stream.  read() (NOT peek — a single
        # peek may return one byte from a dribbling producer) consumes
        # a head block for gzip magic + format sniffing; the head is
        # replayed through a pushback stream.
        import sys

        from findkmer_tpu.io.fasta import pushback_stream

        raw = sys.stdin.buffer
        head = raw.read(4096)
        if head[:2] == b"\x1f\x8b":
            import gzip

            f = gzip.GzipFile(fileobj=pushback_stream(head, raw))
            if fmt == "auto":
                head2 = f.read(4096)  # decompressed head for the sniff
                f = pushback_stream(head2, f)
                fmt = sniff_head(head2)
        else:
            f = pushback_stream(head, raw)
            if fmt == "auto":
                fmt = sniff_head(head)
        if fmt == "fastq":
            return FastqReader(f, min_qual=cfg.min_qual,
                               qual_offset=cfg.qual_offset), fused
        if fmt == "sam":
            return SamReader(f, min_qual=cfg.min_qual,
                             qual_offset=cfg.qual_offset), fused
        if fmt == "bam":
            return BamReader(f, min_qual=cfg.min_qual,
                             qual_offset=cfg.qual_offset), fused
        _check_no_qual(cfg, path)
        return FastaReader(f, strip_ws=not fused), fused
    if fmt == "auto":
        fmt = sniff_format(path)
    if fmt == "fastq":
        return FastqReader(path, min_qual=cfg.min_qual,
                           qual_offset=cfg.qual_offset), fused
    if fmt == "sam":
        return SamReader(path, min_qual=cfg.min_qual,
                         qual_offset=cfg.qual_offset), fused
    if fmt == "bam":
        return BamReader(path, min_qual=cfg.min_qual,
                         qual_offset=cfg.qual_offset), fused
    _check_no_qual(cfg, path)
    return FastaReader(path, strip_ws=not fused), fused


def _check_no_qual(cfg: Config, path) -> None:
    if cfg.min_qual:
        raise ValueError(
            f"--min-qual set but {path!r} sniffed as FASTA, which has "
            "no quality scores"
        )


def _batches_from_reader(reader, fused: bool, cfg: Config, *, stats=None):
    if fused:
        return _batches_fused(reader, cfg, stats=stats)
    # non-fused branch runs only when the native lib is absent or
    # use_native_encode is off, so prefer_native could never pick the
    # C encoder here anyway
    return batches_from_codes(
        code_stream(reader, prefer_native=False, stats=stats),
        cfg,
        stats=stats,
    )


def per_record_spectra(
    path,
    cfg: Config,
    *,
    counter=None,
    stats: Optional[StreamStats] = None,
):
    """Yield (header, finalized spectrum) per input record.

    Each record runs the normal batch pipeline against a fresh counter
    state — shapes are identical across records, so the device program
    compiles once and is reused for every record.  Memory is bounded by
    one record's in-flight batches (the spectrum itself for sparse
    tables).  Works for FASTA and FASTQ (one spectrum per read)."""
    from itertools import chain

    from findkmer_tpu.models.counter import make_counter

    if counter is None:
        counter = make_counter(cfg)
    reader, fused = _open_reader(path, cfg)
    try:
        it = reader.chunks()

        def one_record(first):
            yield first
            if first.final:
                return
            for ch in it:
                yield ch
                if ch.final:
                    return

        while True:
            first = next(it, None)
            if first is None:
                return
            rec = one_record(first)
            batches = _batches_from_reader(
                _ChunkIterReader(rec), fused, cfg, stats=stats
            )
            state = counter.init_state()
            # threaded=False: a producer thread PER RECORD would cost
            # more than it overlaps for short records (FASTQ reads);
            # async device_put still overlaps H2D with compute
            for rows in prefetch_to_device(
                batches, cfg.prefetch, put=counter.put_batch,
                threaded=False,
            ):
                state = counter.step(state, rows)
            # drain rec in case the record was pure whitespace (no
            # batches consumed it past the final marker)
            for _ in rec:
                pass
            yield first.header, counter.finalize(state)
    finally:
        reader.close()


def prefetch_to_device(
    batches: Iterator[np.ndarray], depth: int, device=None,
    threaded: bool = True, put=None,
) -> Iterator[jax.Array]:
    """Keep `depth` batches' H2D transfers in flight ahead of consumption.

    Producer thread + async jax.device_put: host batching (FASTA parse,
    encode, pack) overlaps the H2D transfer AND device compute, so
    end-to-end throughput approaches max(host, transfer, compute) instead
    of their sum — the double-buffered host->HBM prefetch of SURVEY.md
    §2.2 (PP analog).  The numpy/C hot loops release the GIL, so one
    thread suffices.
    """
    from collections import deque

    if put is None:
        if device is None:
            device = jax.local_devices()[0]
        put = lambda b: jax.device_put(b, device)  # noqa: E731
    depth = max(1, depth)

    if not threaded:
        q: deque[jax.Array] = deque()
        it = iter(batches)
        try:
            for _ in range(depth):
                q.append(put(next(it)))
        except StopIteration:
            pass
        while q:
            out = q.popleft()
            try:
                q.append(put(next(it)))
            except StopIteration:
                pass
            yield out
        return

    import queue
    import threading

    _END = object()
    host_q: "queue.Queue" = queue.Queue(maxsize=depth)
    stop = threading.Event()

    def _put(item) -> bool:
        # stop-aware put: a consumer that exits early (step raised)
        # sets `stop`, and the producer must never block forever on a
        # full queue — that leaked the thread, the open reader, and
        # the batch generator for the process lifetime
        while not stop.is_set():
            try:
                host_q.put(item, timeout=0.2)
                return True
            except queue.Full:
                continue
        return False

    def producer():
        try:
            for b in batches:
                if not _put(b):
                    return
            _put(_END)
        except BaseException as e:  # surface errors in the consumer
            _put(e)

    t = threading.Thread(target=producer, daemon=True)
    t.start()

    dq: deque[jax.Array] = deque()
    done = False
    try:
        while True:
            while not done and len(dq) < depth:
                item = host_q.get()
                if item is _END:
                    done = True
                elif isinstance(item, BaseException):
                    raise item
                else:
                    dq.append(put(item))
            if not dq:
                break
            yield dq.popleft()
    finally:
        stop.set()
        # drain until the producer has actually exited (one transient
        # empty read is NOT proof it finished — it may be mid-encode)
        while t.is_alive():
            try:
                host_q.get(timeout=0.05)
            except queue.Empty:
                pass
        t.join()
        if hasattr(batches, "close"):
            batches.close()  # deterministic reader/file cleanup


def count_file(
    path,
    cfg: Config,
    *,
    stats: Optional[StreamStats] = None,
    timers=None,
):
    """Single-host end-to-end count: the F1 call stack (SURVEY.md §3.2).

    Returns the finalized spectrum (dense np counts or sparse
    (codes, counts)) — formatting lives in output.py.  Pass a
    utils.prof.PhaseTimers to get a host/dispatch/finalize wall-clock
    breakdown (device work is async; "host_batches" is encode+batching
    time, "dispatch" is step submission, "finalize" includes the final
    device drain).
    """
    from findkmer_tpu.models.counter import make_counter

    counter = make_counter(cfg)
    state = counter.init_state()

    def timed_batches():
        it = iter(
            prefetch_to_device(batches_from_file(path, cfg, stats=stats),
                               cfg.prefetch, put=counter.put_batch)
        )
        while True:
            if timers is None:
                try:
                    yield next(it)
                except StopIteration:
                    return
            else:
                with timers.phase("host_batches"):
                    try:
                        rows = next(it)
                    except StopIteration:
                        return
                yield rows

    for rows in timed_batches():
        if timers is None:
            state = counter.step(state, rows)
        else:
            with timers.phase("dispatch"):
                state = counter.step(state, rows)
    if timers is None:
        return counter.finalize(state)
    with timers.phase("finalize"):
        return counter.finalize(state)
