"""ctypes loader for the native C encoder (src/native/encode.c).

The native library is optional: if the shared object has not been built (or
fails to load on this platform), io/encode.py falls back to the numpy LUT
path, and load_error() says why.  It is built on first use with
`cc -fopenmp`, or by hand with `make -C src/native [CC=...]` or `python -m
findkmer_tpu.io.native`.
"""

from __future__ import annotations

import ctypes
import os
import subprocess
import sys
from pathlib import Path
from typing import Optional

import numpy as np

_REPO_ROOT = Path(__file__).resolve().parents[2]
_SRC_DIR = _REPO_ROOT / "src" / "native"
_PKG_DIR = Path(__file__).resolve().parents[1] / "_native"
_LIB_NAME = "libfindkmer_encode.so"

_lib: Optional[ctypes.CDLL] = None
_load_attempted = False
_error = ""  # why the library is not loaded; see load_error()
# The system compiler, not $CC: the build needs OpenMP, and an
# environment's CC can name a toolchain without its runtime (a gcc with
# no libgomp.spec), while the system cc has it.
_CC = "cc"


def _lib_path() -> Path:
    # packaged (setup.py build_ext) location wins; src/native/ is the
    # source-checkout fallback (Makefile or cc autobuild)
    pkg = _PKG_DIR / _LIB_NAME
    if pkg.exists():
        return pkg
    return _SRC_DIR / _LIB_NAME


def build(quiet: bool = True) -> bool:
    """Compile the shared library in-place with cc and OpenMP.  Returns
    True on success.  A failure (compiler error, missing
    compiler, timeout) is kept for load_error() and, unless quiet, also
    written to stderr."""
    global _error
    out = _lib_path()
    cmd = [
        _CC, "-O3", "-march=native", "-std=c17",
        "-fPIC", "-fopenmp", "-shared", "-o", str(out),
        str(_SRC_DIR / "encode.c"),
    ]
    try:
        res = subprocess.run(
            cmd, capture_output=True, timeout=120, cwd=str(_SRC_DIR)
        )
    except (OSError, subprocess.SubprocessError) as e:
        _error = f"{' '.join(cmd)}: {e}"
    else:
        if res.returncode == 0 and out.exists():
            return True
        _error = (f"{' '.join(cmd)}: exit {res.returncode}\n"
                  + res.stderr.decode("utf-8", "replace"))
    if not quiet:
        sys.stderr.write(_error + "\n")
    return False


def load_error() -> str:
    """Why the library is not loaded ("" when it is, or before the first
    load attempt)."""
    return _error


def _load() -> Optional[ctypes.CDLL]:
    global _lib, _load_attempted, _error
    if _load_attempted:
        return _lib
    _load_attempted = True
    autobuild = os.environ.get("FINDKMER_AUTOBUILD", "1") == "1"
    path = _lib_path()
    if not path.exists() and autobuild:
        build()
    if not path.exists():
        _error = _error or f"{path} is not built (FINDKMER_AUTOBUILD=0)"
        return None
    try:
        _lib = _register(path)
    except OSError as e:
        _error = f"{path}: {e}"
    except AttributeError as e:
        # stale .so predating a newer symbol: rebuild once and retry
        _error = f"{path}: {e}"
        if autobuild and build():
            try:
                _lib = _register(_lib_path())
            except (OSError, AttributeError) as e2:
                _error = f"{path} after a rebuild: {e2}"
    if _lib is not None:
        _error = ""
    return _lib


def _register(path) -> ctypes.CDLL:
    """CDLL-load `path` and declare every symbol's signature.

    Raises AttributeError when the library on disk predates a symbol
    (stale build) — _load rebuilds once and retries.  The failed
    handle is dlclose()d first: dlopen caches by path, so without the
    close the retry would silently re-resolve the STALE mapping."""
    lib = ctypes.CDLL(str(path))
    try:
        _declare(lib)
    except AttributeError:
        try:
            import _ctypes

            _ctypes.dlclose(lib._handle)
        except Exception:
            pass
        raise
    return lib


def _declare(lib: ctypes.CDLL) -> None:
    lib.fk_encode.argtypes = [
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_size_t,
    ]
    lib.fk_encode.restype = None
    lib.fk_encode_packed.argtypes = [
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_size_t,
    ]
    lib.fk_encode_packed.restype = None
    lib.fk_count_valid.argtypes = [ctypes.c_void_p, ctypes.c_size_t]
    lib.fk_count_valid.restype = ctypes.c_size_t
    lib.fk_count_acgt.argtypes = [ctypes.c_void_p, ctypes.c_size_t]
    lib.fk_count_acgt.restype = ctypes.c_size_t
    lib.fk_encode_compact.argtypes = [
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_size_t,
    ]
    lib.fk_encode_compact.restype = ctypes.c_size_t
    lib.fk_pack_rows.argtypes = [
        ctypes.c_void_p, ctypes.c_size_t, ctypes.c_size_t,
        ctypes.c_size_t, ctypes.c_size_t, ctypes.c_void_p,
        ctypes.c_void_p,
    ]
    lib.fk_pack_rows.restype = None
    lib.fk_format_spectrum.argtypes = [
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_size_t,
        ctypes.c_uint32, ctypes.c_uint8, ctypes.c_void_p,
    ]
    lib.fk_format_spectrum.restype = ctypes.c_size_t
    lib.fk_parse_spectrum.argtypes = [
        ctypes.c_void_p, ctypes.c_size_t, ctypes.c_int,
        ctypes.c_uint8, ctypes.c_void_p, ctypes.c_void_p,
        ctypes.c_size_t,
    ]
    lib.fk_parse_spectrum.restype = ctypes.c_size_t
    lib.fk_filter_hits.argtypes = [
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
        ctypes.c_longlong, ctypes.c_int, ctypes.c_int,
        ctypes.c_void_p, ctypes.c_size_t, ctypes.c_void_p,
        ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p,
    ]
    lib.fk_filter_hits.restype = None
    lib.fk_filter_prepare.argtypes = [
        ctypes.c_void_p, ctypes.c_longlong, ctypes.c_void_p,
    ]
    lib.fk_filter_prepare.restype = None
    lib.fk_filter_bitmap_hits.argtypes = [
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
        ctypes.c_longlong, ctypes.c_int, ctypes.c_void_p,
        ctypes.c_longlong, ctypes.c_void_p, ctypes.c_void_p,
    ]
    lib.fk_filter_bitmap_hits.restype = None
    lib.fk_fastq_scan.argtypes = [
        ctypes.c_void_p, ctypes.c_longlong, ctypes.c_void_p,
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
        ctypes.c_longlong, ctypes.c_void_p, ctypes.c_void_p,
    ]
    lib.fk_fastq_scan.restype = ctypes.c_longlong
    lib.fk_filter_gather_prepare.argtypes = [
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
        ctypes.c_void_p, ctypes.c_longlong, ctypes.c_void_p,
    ]
    lib.fk_filter_gather_prepare.restype = None
    lib.fk_filter_bitmap_hits2.argtypes = [
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
        ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int,
        ctypes.c_void_p, ctypes.c_longlong, ctypes.c_void_p,
        ctypes.c_void_p,
    ]
    lib.fk_filter_bitmap_hits2.restype = None
    for name in ("fk_merge_runs64", "fk_merge_runs32",
                 "fk_merge_runs64_mt", "fk_merge_runs32_mt"):
        fn = getattr(lib, name)
        fn.argtypes = [
            ctypes.POINTER(ctypes.c_void_p),
            ctypes.POINTER(ctypes.c_void_p),
            ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p,
            ctypes.c_void_p,
        ]
        fn.restype = ctypes.c_size_t


def available() -> bool:
    return _load() is not None


def encode(buf: np.ndarray) -> np.ndarray:
    """bytes/uint8 array -> uint8 codes via the C LUT loop."""
    lib = _load()
    assert lib is not None, "native encoder not available"
    buf = np.ascontiguousarray(buf, dtype=np.uint8)
    out = np.empty_like(buf)
    lib.fk_encode(
        buf.ctypes.data_as(ctypes.c_void_p),
        out.ctypes.data_as(ctypes.c_void_p),
        buf.size,
    )
    return out


def encode_packed(buf: np.ndarray):
    """bytes -> (packed 2-bit codes, validity bitmask, n) in one C pass."""
    lib = _load()
    assert lib is not None, "native encoder not available"
    buf = np.ascontiguousarray(buf, dtype=np.uint8)
    n = buf.size
    packed = np.empty((n + 3) // 4, dtype=np.uint8)
    validmask = np.zeros((n + 7) // 8, dtype=np.uint8)
    lib.fk_encode_packed(
        buf.ctypes.data_as(ctypes.c_void_p),
        packed.ctypes.data_as(ctypes.c_void_p),
        validmask.ctypes.data_as(ctypes.c_void_p),
        n,
    )
    return packed, validmask, n


def encode_compact(buf) -> np.ndarray:
    """Raw FASTA sequence bytes -> compacted codes (whitespace removed,
    non-ACGT -> INVALID) in one C pass."""
    lib = _load()
    assert lib is not None, "native encoder not available"
    if isinstance(buf, (bytes, bytearray, memoryview)):
        buf = np.frombuffer(buf, dtype=np.uint8)
    buf = np.ascontiguousarray(buf, dtype=np.uint8)
    out = np.empty(buf.size, dtype=np.uint8)
    m = lib.fk_encode_compact(
        buf.ctypes.data_as(ctypes.c_void_p),
        out.ctypes.data_as(ctypes.c_void_p),
        buf.size,
    )
    return out[: int(m)]


def encode_compact_into(buf: np.ndarray, out: np.ndarray,
                        offset: int) -> int:
    """Strip+encode raw sequence bytes DIRECTLY into out[offset:] (the
    pipeline's work buffer) — no intermediate codes array, no extra copy.
    Returns the number of codes written (<= buf.size)."""
    lib = _load()
    assert lib is not None, "native encoder not available"
    assert buf.dtype == np.uint8 and buf.flags["C_CONTIGUOUS"]
    assert out.dtype == np.uint8 and out.flags["C_CONTIGUOUS"]
    assert offset + buf.size <= out.size
    return int(
        lib.fk_encode_compact(
            buf.ctypes.data_as(ctypes.c_void_p),
            ctypes.c_void_p(out.ctypes.data + offset),
            buf.size,
        )
    )


def count_acgt(codes: np.ndarray, offset: int, m: int) -> int:
    """Valid (code < 4) count over codes[offset:offset+m], no numpy pass."""
    lib = _load()
    assert lib is not None
    return int(
        lib.fk_count_acgt(
            ctypes.c_void_p(codes.ctypes.data + offset), m
        )
    )


def pack_rows(work: np.ndarray, B: int, L: int, R: int):
    """Flat work buffer -> ((B, R8/4) packed, (B, R8/8) validbits).

    Row i covers work[i*L : i*L+R] (overlapping halos), padded with
    invalid to R8 = R rounded up to 8.
    """
    lib = _load()
    assert lib is not None, "native encoder not available"
    work = np.ascontiguousarray(work, dtype=np.uint8)
    assert work.size >= (B - 1) * L + R
    R8 = (R + 7) // 8 * 8
    packed = np.empty((B, R8 // 4), dtype=np.uint8)
    validbits = np.empty((B, R8 // 8), dtype=np.uint8)
    lib.fk_pack_rows(
        work.ctypes.data_as(ctypes.c_void_p), B, L, R, R8,
        packed.ctypes.data_as(ctypes.c_void_p),
        validbits.ctypes.data_as(ctypes.c_void_p),
    )
    return packed, validbits


def format_spectrum(codes: np.ndarray, counts: np.ndarray, k: int,
                    sep: bytes) -> np.ndarray:
    """Format "KMER<sep>COUNT\\n" lines in one C pass (~10x numpy).

    Returns a uint8 numpy view (NOT bytes): the buffer stays on the
    shared-memory numpy allocator, and file.write()/bytes.join()
    accept it directly — a .tobytes() here would copy GBs through
    PRIVATE anonymous memory, which a lazily-backed VM faults at
    ~17 MB/s (measured on the previous host VM; ROADMAP D10)."""
    lib = _load()
    assert lib is not None, "native encoder not available"
    assert len(sep) == 1, "native formatter supports 1-byte separators"
    codes = np.ascontiguousarray(codes, dtype=np.uint64)
    counts = np.ascontiguousarray(counts, dtype=np.int64)
    n = codes.size
    out = np.empty(n * (k + 22), dtype=np.uint8)
    m = lib.fk_format_spectrum(
        codes.ctypes.data_as(ctypes.c_void_p),
        counts.ctypes.data_as(ctypes.c_void_p),
        n, k, sep[0],
        out.ctypes.data_as(ctypes.c_void_p),
    )
    return out[: int(m)]


def merge_runs(runs):
    """G-way merge of sorted (codes u64, counts) runs, summing counts of
    equal codes -> (codes u64, counts i64) sorted distinct arrays.

    `runs` is a list of (codes, counts) pairs, each sorted ascending by
    code with no duplicates within a run.  One heap-merge C pass — the
    host-side tail of the row-compacted sparse store (the device leaves
    G independent sorted rows; ops/compaction.row_geometry)."""
    lib = _load()
    assert lib is not None, "native encoder not available"
    runs = [
        (np.ascontiguousarray(c, dtype=np.uint64), np.ascontiguousarray(n))
        for c, n in runs
        if c.size
    ]
    G = len(runs)
    if G == 0:
        return (np.empty(0, np.uint64), np.empty(0, np.int64))
    assert G <= 256, "fk_merge_runs supports up to 256 runs"
    # widen to 64-bit when ANY run carries 64-bit counts: keying on
    # runs[0] alone would silently downcast a later run's > 2^31 count
    is64 = any(n.dtype.itemsize == 8 for _, n in runs)
    cdt = np.int64 if is64 else np.int32
    runs = [(c, n.astype(cdt, copy=False)) for c, n in runs]
    code_ptrs = (ctypes.c_void_p * G)(
        *[c.ctypes.data for c, _ in runs]
    )
    cnt_ptrs = (ctypes.c_void_p * G)(
        *[n.ctypes.data for _, n in runs]
    )
    lens = np.array([c.size for c, _ in runs], dtype=np.uintp)
    total = int(lens.sum())
    out_codes = np.empty(total, np.uint64)
    out_counts = np.empty(total, np.int64)
    fn = lib.fk_merge_runs64_mt if is64 else lib.fk_merge_runs32_mt
    m = int(
        fn(
            code_ptrs, cnt_ptrs,
            lens.ctypes.data_as(ctypes.c_void_p), G,
            out_codes.ctypes.data_as(ctypes.c_void_p),
            out_counts.ctypes.data_as(ctypes.c_void_p),
        )
    )
    if m in (-1, (1 << 64) - 1):  # c_size_t returns (size_t)-1 as 2^64-1
        raise RuntimeError("fk_merge_runs failed (run count/size guard)")
    return out_codes[:m], out_counts[:m]


def filter_hits(buf: np.ndarray, starts: np.ndarray, lens: np.ndarray,
                k: int, canonical: bool, table: np.ndarray,
                bloom: np.ndarray, bloom_shift: int):
    """Per-read (hits, valid windows) vs a sorted u64 code table.

    buf holds all reads' bytes; read r spans buf[starts[r]:+lens[r]].
    bloom is the bool one-probe prefilter (see filter.FilterSpec)."""
    lib = _load()
    assert lib is not None, "native encoder not available"
    n = int(starts.size)
    hits = np.empty(n, np.int64)
    wins = np.empty(n, np.int64)
    lib.fk_filter_hits(
        buf.ctypes.data_as(ctypes.c_void_p),
        starts.ctypes.data_as(ctypes.c_void_p),
        lens.ctypes.data_as(ctypes.c_void_p),
        n, k, int(canonical),
        table.ctypes.data_as(ctypes.c_void_p), table.size,
        bloom.ctypes.data_as(ctypes.c_void_p), bloom_shift,
        hits.ctypes.data_as(ctypes.c_void_p),
        wins.ctypes.data_as(ctypes.c_void_p),
    )
    return hits, wins


def filter_prepare(buf: np.ndarray, out: np.ndarray) -> None:
    """Joined read bytes -> device code stream into out (0..3, 4=N)."""
    lib = _load()
    assert lib is not None, "native encoder not available"
    assert buf.dtype == np.uint8 and out.dtype == np.uint8
    assert out.size >= buf.size
    lib.fk_filter_prepare(
        buf.ctypes.data_as(ctypes.c_void_p),
        buf.size,
        out.ctypes.data_as(ctypes.c_void_p),
    )


def filter_bitmap_hits(buf: np.ndarray, starts: np.ndarray,
                       lens: np.ndarray, k: int, words: np.ndarray,
                       halo: int):
    """Per-read (hits, valid windows) from the device hit bitmap.

    buf holds the reads' joined bytes; the window starting at joined
    position p is bit p + halo of `words` (uint32 little-endian, the
    filter_device._filter_step packing)."""
    lib = _load()
    assert lib is not None, "native encoder not available"
    assert words.dtype == np.uint32 and words.flags["C_CONTIGUOUS"]
    n = int(starts.size)
    hits = np.empty(n, np.int64)
    wins = np.empty(n, np.int64)
    lib.fk_filter_bitmap_hits(
        buf.ctypes.data_as(ctypes.c_void_p),
        starts.ctypes.data_as(ctypes.c_void_p),
        lens.ctypes.data_as(ctypes.c_void_p),
        n, k,
        words.ctypes.data_as(ctypes.c_void_p),
        halo,
        hits.ctypes.data_as(ctypes.c_void_p),
        wins.ctypes.data_as(ctypes.c_void_p),
    )
    return hits, wins


def fastq_scan(buf: np.ndarray, max_rec: int = 0):
    """Strict-4-line FASTQ block scan -> per-record offset arrays.

    Returns (seq_s, seq_e, rec_s, rec_e, consumed, err): offsets into
    `buf` of each complete record's sequence span and verbatim record
    span; `consumed` = bytes fully parsed (carry the tail); err != 0
    means a malformed/multi-line record starts at `consumed`.  Zero
    copies: the caller slices/encodes straight from the block."""
    lib = _load()
    assert lib is not None, "native encoder not available"
    assert buf.dtype == np.uint8 and buf.flags["C_CONTIGUOUS"]
    n = int(buf.size)
    if max_rec <= 0:
        max_rec = n // 6 + 2  # "@\n\n+\n\n" = 6 B is the minimum record
    seq_s = np.empty(max_rec, np.int64)
    seq_e = np.empty(max_rec, np.int64)
    rec_s = np.empty(max_rec, np.int64)
    rec_e = np.empty(max_rec, np.int64)
    consumed = ctypes.c_longlong(0)
    err = ctypes.c_int(0)
    nrec = int(
        lib.fk_fastq_scan(
            buf.ctypes.data_as(ctypes.c_void_p), n,
            seq_s.ctypes.data_as(ctypes.c_void_p),
            seq_e.ctypes.data_as(ctypes.c_void_p),
            rec_s.ctypes.data_as(ctypes.c_void_p),
            rec_e.ctypes.data_as(ctypes.c_void_p),
            max_rec,
            ctypes.byref(consumed), ctypes.byref(err),
        )
    )
    return (
        seq_s[:nrec], seq_e[:nrec], rec_s[:nrec], rec_e[:nrec],
        int(consumed.value), int(err.value),
    )


def filter_gather_prepare(buf: np.ndarray, starts: np.ndarray,
                          joined: np.ndarray, lens: np.ndarray,
                          out: np.ndarray) -> None:
    """LUT-encode each read from the block buffer straight into its
    joined-stream slot of the (4-prefilled) device work buffer."""
    lib = _load()
    assert lib is not None, "native encoder not available"
    assert buf.dtype == np.uint8 and out.dtype == np.uint8
    lib.fk_filter_gather_prepare(
        buf.ctypes.data_as(ctypes.c_void_p),
        starts.ctypes.data_as(ctypes.c_void_p),
        joined.ctypes.data_as(ctypes.c_void_p),
        lens.ctypes.data_as(ctypes.c_void_p),
        int(starts.size),
        out.ctypes.data_as(ctypes.c_void_p),
    )


def filter_bitmap_hits2(buf: np.ndarray, byte_starts: np.ndarray,
                        joined: np.ndarray, lens: np.ndarray, k: int,
                        words: np.ndarray, halo: int):
    """filter_bitmap_hits with separate byte (block) and bitmap
    (joined-stream) coordinates — the offsets-based zero-copy flow."""
    lib = _load()
    assert lib is not None, "native encoder not available"
    assert words.dtype == np.uint32 and words.flags["C_CONTIGUOUS"]
    n = int(byte_starts.size)
    hits = np.empty(n, np.int64)
    wins = np.empty(n, np.int64)
    lib.fk_filter_bitmap_hits2(
        buf.ctypes.data_as(ctypes.c_void_p),
        byte_starts.ctypes.data_as(ctypes.c_void_p),
        joined.ctypes.data_as(ctypes.c_void_p),
        lens.ctypes.data_as(ctypes.c_void_p),
        n, k,
        words.ctypes.data_as(ctypes.c_void_p),
        halo,
        hits.ctypes.data_as(ctypes.c_void_p),
        wins.ctypes.data_as(ctypes.c_void_p),
    )
    return hits, wins


def count_valid(buf: np.ndarray) -> int:
    lib = _load()
    assert lib is not None, "native encoder not available"
    buf = np.ascontiguousarray(buf, dtype=np.uint8)
    return int(lib.fk_count_valid(buf.ctypes.data_as(ctypes.c_void_p), buf.size))


if __name__ == "__main__":
    ok = build(quiet=False)
    print(f"build: {'ok' if ok else 'FAILED'} -> {_lib_path()}")
    if ok:
        test = np.frombuffer(b"ACGTNacgtX", dtype=np.uint8)
        print("encode:", encode(test))


def parse_spectrum(buf, k: int, sep: bytes):
    """Parse a sorted KMER<sep>COUNT buffer -> (codes u64, counts i64).

    Returns None when the input is not a clean sorted uppercase
    spectrum (callers fall back to the Python parser).  One OMP C pass
    at memory bandwidth."""
    lib = _load()
    assert lib is not None, "native encoder not available"
    assert len(sep) == 1
    mv = memoryview(buf)
    n_max = len(mv) // (k + 2) + 2
    codes = np.empty(n_max, np.uint64)
    counts = np.empty(n_max, np.int64)
    src = np.frombuffer(mv, dtype=np.uint8)
    m = lib.fk_parse_spectrum(
        src.ctypes.data_as(ctypes.c_void_p), src.size, k, sep[0],
        codes.ctypes.data_as(ctypes.c_void_p),
        counts.ctypes.data_as(ctypes.c_void_p), n_max,
    )
    m = int(m)
    if m == (1 << 64) - 1 or m == -1:
        return None
    return codes[:m], counts[:m]
