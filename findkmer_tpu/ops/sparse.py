"""Sparse (sorted-run) count store for large k (k > 10, e.g. k=21).

The reference's count structure is an in-memory array/trie (SURVEY.md §2.1
R4); a 4^21 direct table (~17.6 TB) is impossible, so big k needs a sparse
exact structure.  The answer here is NOT a hash table with probing
(scatter races, data-dependent loops) but sort + run-length encoding
(SURVEY.md §7 M5: "prefer sort+run-length (segment_sum): fully vectorized,
exact, no probing races").

Architecture (log-structured; bench/probe_sort*.py):

  Ingest appends RAW window codes — no per-batch or per-flush sorting at
  all.  Merging sorted runs costs a re-sort of the concatenation, so any
  sort before the final one is wasted work.  One COMPACTION chain runs
  rarely (memory-pressure threshold, checkpoint, finalize):

      sort (unstable, keys only)  ->  RLE by scans  ->  [squeeze]

  with run totals computed positionally (cummax over iota — monotone,
  so exact) for raw input, or by wrap-safe positional value
  propagation (rle_val) when a count-carrying store re-enters the sort.
  No gathers on the common raw path.

Codes are (hi, lo) uint32 pairs (2k-bit code split at bit 32) so no 64-bit
integers are needed on device (SURVEY.md §7 hard part 4).  k <= 15 fits a
single uint32 (1-key sorts).  The sentinel
hi = lo = 0xffffffff sorts after every real code (real hi < 2^30 for
k <= 31) and marks empty/invalid slots.

Everything is static-shaped; callers pad concatenations to a small ladder
of sizes so only a handful of shapes ever compile.
"""

from __future__ import annotations

from functools import partial
from typing import Tuple

import jax
import jax.numpy as jnp
from jax import lax

# numpy (not jnp) so importing this module never initializes a JAX backend
import numpy as np

SENTINEL = np.uint32(0xFFFFFFFF)
SENTINEL16 = np.uint16(0xFFFF)


def hi_dtype(k: int):
    """Device dtype of the hi code plane for k > 15.

    16 <= k <= 23: the hi word has 2k-32 <= 14 meaningful bits, so a
    real hi can never reach 0xFFFF and the plane fits uint16 with the
    all-ones sentinel intact: the 2-key sort and the ingest append move
    6 B/window instead of 8 (bench/probe_hisort.py; not yet measured
    on the H100, ROADMAP S3).  k = 24 needs exactly 16 bits (sentinel would collide); k >= 24 stays
    uint32."""
    return np.uint16 if 16 <= k <= 23 else np.uint32


def sent_of(dtype) -> np.integer:
    """The all-ones sentinel value of an unsigned code-plane dtype."""
    return np.dtype(dtype).type(np.iinfo(np.dtype(dtype)).max)


# ----------------------------------------------------------------------
# round-2 compaction chain (log-structured store)
# ----------------------------------------------------------------------

def _adj_flags(hi, lo):
    """(is_start, is_end) of equal-code runs in sorted (hi, lo)."""
    s1h = jnp.full((1,), sent_of(hi.dtype), hi.dtype)
    s1l = jnp.full((1,), SENTINEL, jnp.uint32)
    is_start = (hi != jnp.concatenate([s1h, hi[:-1]])) | (
        lo != jnp.concatenate([s1l, lo[:-1]])
    )
    is_end = (hi != jnp.concatenate([hi[1:], s1h])) | (
        lo != jnp.concatenate([lo[1:], s1l])
    )
    return is_start, is_end


def _is_sent(hi, lo, wide: bool):
    """Sentinel test for (hi, lo) code arrays.

    Wide stores (k >= 16) mark holes as hi = lo = all-ones, and a REAL
    code's hi can never be all-ones (hi < 2^14 for the uint16 plane at
    k <= 23, < 2^30 for uint32 up to k <= 31) — but its lo CAN be
    0xFFFFFFFF (any k-mer ending in 16 T's, e.g. a poly-T homopolymer
    run), so the hole test must key on hi.  Narrow stores (k <= 15)
    carry a dummy all-zero hi and codes < 2^30, so there lo is the
    discriminating word."""
    return (hi == sent_of(hi.dtype)) if wide else (lo == SENTINEL)


def rle_pos(hi, lo, wide: bool = True):
    """Run totals of sorted codes with IMPLICIT count 1 per entry.

    Returns cnt: run length at each run's END position, 0 elsewhere and
    at sentinels.  Exact for any input: positions are monotone, so the
    cummax propagation cannot be corrupted by arithmetic wrap (unlike
    value-based propagation — see rle_val)."""
    n = hi.shape[0]
    is_start, is_end = _adj_flags(hi, lo)
    idx = jnp.arange(n, dtype=jnp.int32)
    spos = lax.cummax(jnp.where(is_start, idx, 0), axis=0)
    is_sent = _is_sent(hi, lo, wide)
    return jnp.where(is_end & ~is_sent, idx - spos + 1, 0)


def seg_totals(is_start, cnt, axis: int):
    """Segmented run sums: at each position, the sum of cnt from the
    position's run start (is_start flags) through the position.

    Hand-unrolled Hillis-Steele AFFINE scan — log2(n) levels of
    (shift, where, add) over a (carry-mask, partial-sum) pair, with no
    gather and no lax.associative_scan.  Both were avoided for the
    previous accelerator; whether segment_sum or associative_scan is
    faster on the H100 is ROADMAP D4.

    Wrap-safe: sums are computed in the unsigned image of the count
    dtype and stay exact modulo the dtype, so any run total that fits
    the dtype is exact regardless of wraps along the way (same contract
    as the cumsum-difference formulation it replaces)."""
    udt = jnp.uint64 if cnt.dtype == jnp.int64 else jnp.uint32
    b = cnt.astype(udt)
    m = ~is_start
    n = b.shape[axis]
    d = 1
    while d < n:
        mp = _shift_right(m, d, axis, False)
        bp = _shift_right(b, d, axis, 0)
        b = b + jnp.where(m, bp, jnp.zeros_like(bp))
        m = m & mp
        d *= 2
    return b


def _shift_right(a, d: int, axis: int, fill):
    """a shifted +d along axis, vacated slots filled with `fill`."""
    pad = [(0, 0)] * a.ndim
    pad[axis] = (d, 0)
    padded = jnp.pad(a, pad, constant_values=fill)
    return lax.slice_in_dim(padded, 0, a.shape[axis], axis=axis)


def rle_val(hi, lo, cnt, wide: bool = True):
    """Run totals of sorted codes carrying explicit counts.

    Segmented affine scan (seg_totals) over the sorted count plane —
    gather-free, wrap-safe.  Returns cnt' at run ENDS, 0 elsewhere."""
    is_start, is_end = _adj_flags(hi, lo)
    s = seg_totals(is_start, cnt, axis=0)
    is_sent = _is_sent(hi, lo, wide)
    return jnp.where(is_end & ~is_sent, s, 0).astype(cnt.dtype)


@partial(jax.jit, static_argnames=("cdtype",))
def compact_raw(hi, lo, cdtype=jnp.int32):
    """Raw (SENT-masked) codes -> sorted codes + run-total counts.

    Output is 'hole-laden': duplicate positions carry cnt 0 but keep
    their (sorted) code, so the array stays sorted by code and can
    re-enter a later count-carrying sort unchanged.  distinct = number
    of nonzero counts."""
    hi, lo = lax.sort((hi, lo), num_keys=2, is_stable=False)
    cnt = rle_pos(hi, lo).astype(cdtype)
    return hi, lo, cnt, jnp.count_nonzero(cnt)


@partial(jax.jit, static_argnames=("cdtype",))
def compact_raw_narrow(lo, cdtype=jnp.int32):
    """k <= 15 variant: single-uint32 codes, 1-key sort."""
    (lo,) = lax.sort((lo,), num_keys=1, is_stable=False)
    hi = jnp.zeros_like(lo)
    cnt = rle_pos(hi, lo, wide=False).astype(cdtype)
    return lo, cnt, jnp.count_nonzero(cnt)


@jax.jit
def compact_counted(hi, lo, cnt):
    """Count-carrying compaction (store re-entering with new raw codes
    appended as cnt=1 entries): sort3 + value-RLE."""
    hi, lo, cnt = lax.sort((hi, lo, cnt), num_keys=2, is_stable=False)
    cnt = rle_val(hi, lo, cnt)
    return hi, lo, cnt, jnp.count_nonzero(cnt)


@jax.jit
def compact_counted_narrow(lo, cnt):
    (lo, cnt) = lax.sort((lo, cnt), num_keys=1, is_stable=False)
    hi = jnp.zeros_like(lo)
    cnt = rle_val(hi, lo, cnt, wide=False)
    return lo, cnt, jnp.count_nonzero(cnt)


@jax.jit
def squeeze(hi, lo, cnt):
    """Push zero-count holes to the end (re-keyed sort), keeping live
    entries sorted by code at the front.  Used before checkpointing /
    re-entering so store arrays can be sliced to their live ladder."""
    live = cnt > 0
    khi = jnp.where(live, hi, sent_of(hi.dtype))
    klo = jnp.where(live, lo, SENTINEL)
    return lax.sort((khi, klo, cnt), num_keys=2, is_stable=False)


@jax.jit
def squeeze_narrow(lo, cnt):
    klo = jnp.where(cnt > 0, lo, SENTINEL)
    (lo, cnt) = lax.sort((klo, cnt), num_keys=1, is_stable=False)
    return lo, cnt


# --- 2D (row-wise) variants: one independent store per device row.
# Sorting along dimension=1 of a (n_dev, N) array whose rows are sharded
# over the mesh is embarrassingly parallel — XLA partitions it with zero
# communication.  These power the distributed dp_sparse path.

def _adj_flags_2d(hi, lo):
    G = hi.shape[0]
    sh = jnp.full((G, 1), sent_of(hi.dtype), hi.dtype)
    sl = jnp.full((G, 1), SENTINEL, jnp.uint32)
    is_start = (hi != jnp.concatenate([sh, hi[:, :-1]], axis=1)) | (
        lo != jnp.concatenate([sl, lo[:, :-1]], axis=1)
    )
    is_end = (hi != jnp.concatenate([hi[:, 1:], sh], axis=1)) | (
        lo != jnp.concatenate([lo[:, 1:], sl], axis=1)
    )
    return is_start, is_end


def rle_pos_2d(hi, lo, wide: bool = True):
    is_start, is_end = _adj_flags_2d(hi, lo)
    idx = lax.broadcasted_iota(jnp.int32, hi.shape, 1)
    spos = lax.cummax(jnp.where(is_start, idx, 0), axis=1)
    return jnp.where(is_end & ~_is_sent(hi, lo, wide), idx - spos + 1, 0)


def rle_val_2d(hi, lo, cnt, wide: bool = True):
    """Row-wise rle_val (same segmented-scan scheme; see rle_val)."""
    is_start, is_end = _adj_flags_2d(hi, lo)
    s = seg_totals(is_start, cnt, axis=1)
    return jnp.where(is_end & ~_is_sent(hi, lo, wide), s, 0).astype(
        cnt.dtype
    )


@partial(jax.jit, static_argnames=("cdtype",))
def compact_raw_2d(hi, lo, cdtype=jnp.int32):
    hi, lo = lax.sort((hi, lo), dimension=1, num_keys=2, is_stable=False)
    cnt = rle_pos_2d(hi, lo).astype(cdtype)
    return hi, lo, cnt, jnp.count_nonzero(cnt, axis=1)


@partial(jax.jit, static_argnames=("cdtype",))
def compact_raw_narrow_2d(lo, cdtype=jnp.int32):
    (lo,) = lax.sort((lo,), dimension=1, num_keys=1, is_stable=False)
    hi = jnp.zeros_like(lo)
    cnt = rle_pos_2d(hi, lo, wide=False).astype(cdtype)
    return lo, cnt, jnp.count_nonzero(cnt, axis=1)


@jax.jit
def compact_counted_2d(hi, lo, cnt):
    hi, lo, cnt = lax.sort(
        (hi, lo, cnt), dimension=1, num_keys=2, is_stable=False
    )
    cnt = rle_val_2d(hi, lo, cnt)
    return hi, lo, cnt, jnp.count_nonzero(cnt, axis=1)


@jax.jit
def compact_counted_narrow_2d(lo, cnt):
    (lo, cnt) = lax.sort(
        (lo, cnt), dimension=1, num_keys=1, is_stable=False
    )
    hi = jnp.zeros_like(lo)
    cnt = rle_val_2d(hi, lo, cnt, wide=False)
    return lo, cnt, jnp.count_nonzero(cnt, axis=1)


@jax.jit
def squeeze_2d(hi, lo, cnt):
    """Row-wise squeeze: push zero-count holes to each row's end."""
    live = cnt > 0
    khi = jnp.where(live, hi, sent_of(hi.dtype))
    klo = jnp.where(live, lo, SENTINEL)
    return lax.sort(
        (khi, klo, cnt), dimension=1, num_keys=2, is_stable=False
    )


@jax.jit
def squeeze_narrow_2d(lo, cnt):
    klo = jnp.where(cnt > 0, lo, SENTINEL)
    (lo, cnt) = lax.sort(
        (klo, cnt), dimension=1, num_keys=1, is_stable=False
    )
    return lo, cnt


# ----------------------------------------------------------------------
# global-order finalize chain (round 2): the row store collapses to ONE
# globally sorted distinct sequence on device, so the host needs no
# G-way heap merge at all — concatenated chunks ARE the spectrum.  Counts
# travel as exceptions (positions with count > 1; ~1% of entries at chr
# scale where ~99% of distinct 21-mers are singletons), cutting D2H bytes
# from 12 to ~8 B/entry (wide) / 8 to ~4 (narrow).
# ----------------------------------------------------------------------

@jax.jit
def global_compact_wide(hi, lo, cnt):
    """Flat global sort + value-RLE + squeeze of a (hi, lo, cnt) store.

    Input arrays may be any shape (row stores arrive (G, C)); holes
    (cnt == 0) and padding are sentinel-keyed and sort to the end.
    Returns flat (hi, lo, cnt) with a globally sorted, distinct live
    prefix, plus n_live and n_multi (live entries with count > 1)."""
    hi, lo, cnt = (a.reshape(-1) for a in (hi, lo, cnt))
    sh = sent_of(hi.dtype)
    live = cnt > 0
    hi = jnp.where(live, hi, sh)
    lo = jnp.where(live, lo, SENTINEL)
    hi, lo, cnt = lax.sort((hi, lo, cnt), num_keys=2, is_stable=False)
    cnt = rle_val(hi, lo, cnt)
    live = cnt > 0
    hi, lo, cnt = lax.sort(
        (jnp.where(live, hi, sh), jnp.where(live, lo, SENTINEL),
         cnt),
        num_keys=2, is_stable=False,
    )
    return hi, lo, cnt, jnp.count_nonzero(cnt), jnp.sum(cnt > 1)


@jax.jit
def global_compact_narrow(lo, cnt):
    """k <= 15 variant of global_compact_wide (single-uint32 codes)."""
    lo, cnt = (a.reshape(-1) for a in (lo, cnt))
    lo = jnp.where(cnt > 0, lo, SENTINEL)
    lo, cnt = lax.sort((lo, cnt), num_keys=1, is_stable=False)
    hi = jnp.zeros_like(lo)
    cnt = rle_val(hi, lo, cnt, wide=False)
    lo, cnt = lax.sort(
        (jnp.where(cnt > 0, lo, SENTINEL), cnt),
        num_keys=1, is_stable=False,
    )
    return lo, cnt, jnp.count_nonzero(cnt), jnp.sum(cnt > 1)


# ---- wire v2 (round 5): orthogonal code/count legs -------------------
# The round-4 wire bundled codes+exceptions (slice_live_exc*) and
# assumed n_multi ~ 1% of entries; bench/probe_finalize_wire.py measured
# the pinned merge-metric store at n_multi == N, where the (i32, i32)
# exception tables outweigh the code plane 2:1.  v2 picks each leg from
# measured byte counts (whether it pays over PCIe is ROADMAP D6):
#   codes:  3 x u8 byte planes + run-coded top bits (code >> 24) when
#           8 * n_runs < N (always for k <= 12; k = 21: <= 4^9+1 runs)
#           — 3 B/entry instead of 4; else the round-4 legs.
#   counts: a u8 plane + >255 escapes when 8 * n_multi > N (repeat-heavy
#           stores) — 1 B/entry instead of 8 B/exception; else the
#           round-4 count-exception leg.
# Both decisions are data-driven host-side from wire_stats, and every
# combination is byte-exact (tests force each mode).

@jax.jit
def wire_stats_narrow(lo, cnt):
    """(n_big255, n_runs_top24) of a globally compacted narrow store.

    n_runs counts value changes of the composite top word (code bits
    >= 24) over the FULL array — the live prefix's runs plus at most
    one sentinel-tail transition (sentinels are all equal)."""
    top = lo >> 24
    change = jnp.concatenate(
        [jnp.ones((1,), bool), top[1:] != top[:-1]]
    )
    return jnp.stack(
        [jnp.sum(cnt > 255), jnp.sum(change)]
    ).astype(jnp.int32)


@jax.jit
def wire_stats_wide(hi, lo, cnt):
    """wire_stats_narrow for (hi, lo) stores: top = hi:lo[31:24]."""
    top = (hi.astype(jnp.uint32) << 8) | (lo >> 24)
    change = jnp.concatenate(
        [jnp.ones((1,), bool), top[1:] != top[:-1]]
    )
    return jnp.stack(
        [jnp.sum(cnt > 255), jnp.sum(change)]
    ).astype(jnp.int32)


@partial(jax.jit, static_argnames=("N", "HR"))
def slice_bytes_runs_narrow(lo, N: int, HR: int):
    """Code leg: 3 u8 byte planes of lo[:N] + run-coded top bits.

    Returns (b0, b1, b2, run_starts i32, run_tops u32); run entries
    past the last real run are filled with start == N.  Host rebuilds
    codes = (run_top << 24) | b2 << 16 | b1 << 8 | b0 segment-wise
    (apply_hi_runs with shift=24)."""
    loN = lo[:N]
    top = loN >> 24
    change = jnp.concatenate(
        [jnp.ones((1,), bool), top[1:] != top[:-1]]
    )
    (ridx,) = jnp.nonzero(change, size=HR, fill_value=N)
    ridx = ridx.astype(jnp.int32)
    rtop = jnp.take(top, jnp.clip(ridx, 0, N - 1))
    return (
        (loN & 0xFF).astype(jnp.uint8),
        ((loN >> 8) & 0xFF).astype(jnp.uint8),
        ((loN >> 16) & 0xFF).astype(jnp.uint8),
        ridx, rtop,
    )


@partial(jax.jit, static_argnames=("N", "HR"))
def slice_bytes_runs_wide(hi, lo, N: int, HR: int):
    """slice_bytes_runs_narrow for (hi, lo) stores: the run value
    carries ALL bits >= 24 ((hi << 8) | lo[31:24]), so only 3 B/entry
    cross the wire regardless of k (chosen only when the run table is
    small: 8 * n_runs < N)."""
    hiN, loN = hi[:N], lo[:N]
    top = (hiN.astype(jnp.uint32) << 8) | (loN >> 24)
    change = jnp.concatenate(
        [jnp.ones((1,), bool), top[1:] != top[:-1]]
    )
    (ridx,) = jnp.nonzero(change, size=HR, fill_value=N)
    ridx = ridx.astype(jnp.int32)
    rtop = jnp.take(top, jnp.clip(ridx, 0, N - 1))
    return (
        (loN & 0xFF).astype(jnp.uint8),
        ((loN >> 8) & 0xFF).astype(jnp.uint8),
        ((loN >> 16) & 0xFF).astype(jnp.uint8),
        ridx, rtop,
    )


@partial(jax.jit, static_argnames=("N", "HR"))
def slice_lo_runs(hi, lo, N: int, HR: int):
    """Round-4 wide code leg, decomposed from slice_live_exc_runs:
    lo[:N] + run-coded hi (shift 32).  Used when the byte-plane leg's
    run table would be too big (8 * n_runs_top24 >= N)."""
    hiN, loN = hi[:N], lo[:N]
    change = jnp.concatenate(
        [jnp.ones((1,), bool), hiN[1:] != hiN[:-1]]
    )
    (ridx,) = jnp.nonzero(change, size=HR, fill_value=N)
    ridx = ridx.astype(jnp.int32)
    rhi = jnp.take(hiN, jnp.clip(ridx, 0, N - 1))
    return loN, ridx, rhi


@partial(jax.jit, static_argnames=("N",))
def slice_codes(codes, N: int):
    """Trivial code leg: slice each plane to the live ladder."""
    return tuple(c[:N] for c in codes)


@partial(jax.jit, static_argnames=("N", "E"))
def slice_exc(cnt, N: int, E: int):
    """Count leg A (sparse counts): positions with count > 1 and their
    counts; entries past n_multi are fill (idx 0) — host slices."""
    cntN = cnt[:N]
    (idx,) = jnp.nonzero(cntN > 1, size=E, fill_value=0)
    idx = idx.astype(jnp.int32)
    return idx, jnp.take(cntN, idx)


@partial(jax.jit, static_argnames=("N", "E"))
def slice_cnt_plane(cnt, N: int, E: int):
    """Count leg B (repeat-heavy stores): a u8 plane (counts clamped to
    255) + escape exceptions for counts > 255.  1 B/entry on the wire
    instead of 8 B/exception; exact because escapes are by position."""
    cntN = cnt[:N]
    cnt8 = jnp.minimum(cntN, 255).astype(jnp.uint8)
    (idx,) = jnp.nonzero(cntN > 255, size=E, fill_value=0)
    idx = idx.astype(jnp.int32)
    return cnt8, idx, jnp.take(cntN, idx)


@jax.jit
def row_multi(cnt):
    """Per-row number of live entries with count > 1 (exception count)."""
    return jnp.sum(cnt > 1, axis=1)


@jax.jit
def row_big255(cnt):
    """Per-row number of entries with count > 255 (count-plane escapes)."""
    return jnp.sum(cnt > 255, axis=1)


@partial(jax.jit, static_argnames=("N", "E"))
def wire_rows_cnt_plane_2d(cnt, N: int, E: int):
    """Row-store count leg B (repeat-heavy mesh stores): per-row u8
    count plane (clamped to 255) + per-row >255 escapes.

    The dp_sparse analog of slice_cnt_plane: when most entries repeat,
    the padded (G, E) exception tables of wire_rows_exc_2d cost 8 B per
    slot vs 1 B/entry here (chosen host-side when N < 8*E).  Escape
    positions past row g's big-count are fill == N."""
    cntN = cnt[:, :N]
    cnt8 = jnp.minimum(cntN, 255).astype(jnp.uint8)
    iota = lax.broadcasted_iota(jnp.int32, cntN.shape, 1)
    ek = jnp.where(cntN > 255, iota, jnp.int32(N))
    (ek,) = lax.sort((ek,), dimension=1, num_keys=1, is_stable=False)
    eidx = ek[:, :E]
    ecnt = jnp.take_along_axis(cntN, jnp.clip(eidx, 0, N - 1), axis=1)
    return cnt8, eidx, ecnt


@partial(jax.jit, static_argnames=("N", "E"))
def wire_rows_exc_2d(store, N: int, E: int):
    """Per-row coded wire for a squeezed row store (dp_sparse finalize).

    Rows must be live-prefix sorted (squeeze_2d/_squeeze_slice output):
    entries [0, n_live_g) of row g are sorted distinct codes, the rest
    sentinel holes.  Returns the code planes sliced to N columns plus
    per-row count exceptions (positions with count > 1 and their
    counts; positions past row g's n_multi are fill == N), so the cnt
    plane never crosses the wire — the multi-chip analog of the
    single-chip ordered finalize (models/counter.py _ordered_pull)."""
    cnt = store[-1][:, :N]
    codes = tuple(c[:, :N] for c in store[:-1])
    iota = lax.broadcasted_iota(jnp.int32, cnt.shape, 1)
    ek = jnp.where(cnt > 1, iota, jnp.int32(N))
    (ek,) = lax.sort((ek,), dimension=1, num_keys=1, is_stable=False)
    eidx = ek[:, :E]
    ecnt = jnp.take_along_axis(cnt, jnp.clip(eidx, 0, N - 1), axis=1)
    return codes, eidx, ecnt


@partial(jax.jit, static_argnames=("N", "HR"))
def hi_runs_2d(hi, N: int, HR: int):
    """Per-row run coding of the hi plane (sorted rows, 16 <= k <= 26).

    A sorted row's hi word changes at most 4^(k-16) times (+1 for the
    sentinel hole tail), so the wire carries (run start, hi value)
    pairs per row instead of 4 B/entry of hi.  Fill entries carry
    start == N."""
    hiN = hi[:, :N]
    G = hiN.shape[0]
    change = jnp.concatenate(
        [jnp.ones((G, 1), bool), hiN[:, 1:] != hiN[:, :-1]], axis=1
    )
    iota = lax.broadcasted_iota(jnp.int32, hiN.shape, 1)
    rk = jnp.where(change, iota, jnp.int32(N))
    (rk,) = lax.sort((rk,), dimension=1, num_keys=1, is_stable=False)
    ridx = rk[:, :HR]
    rhi = jnp.take_along_axis(hiN, jnp.clip(ridx, 0, N - 1), axis=1)
    return ridx, rhi


def apply_hi_runs(codes, a: int, ridx, rhi, shift: int = 32) -> None:
    """OR run-coded words into uint64 `codes` (span [a, a+m)) in place.

    ridx: sorted run start positions (absolute, real entries only);
    rhi: the value of each run, OR'd in at bit `shift` (32 for the
    round-4 hi-plane runs; 24 for the byte-plane wire's top runs).
    Only runs overlapping the span are touched, in one vectorized OR:
    a dp_sparse row at k=21 carries hundreds of runs, and the finalize
    calls this once per row (~10^5 rows)."""
    m = codes.shape[0]
    e = a + m
    j0 = max(int(np.searchsorted(ridx, a, side="right")) - 1, 0)
    j1 = int(np.searchsorted(ridx, e, side="left"))
    if j1 <= j0:
        return
    # the overlapping runs tile [s[0], t[-1]) of the span without gaps
    s = np.maximum(np.asarray(ridx[j0:j1], np.int64), a) - a
    t = np.append(s[1:], min(int(ridx[j1]), e) - a if j1 < ridx.size
                  else m)
    vals = np.asarray(rhi[j0:j1]).astype(np.uint64) << np.uint64(shift)
    codes[s[0]:t[-1]] |= np.repeat(vals, t - s)


def ladder(n: int, floor: int = 1 << 20) -> int:
    """Smallest padded size >= n from the {1, 1.5} x 2^i ladder.

    Bounds both padding waste (<= 50%, usually <= 33%) and the number of
    distinct compaction shapes that ever compile."""
    c = floor
    while True:
        if n <= c:
            return c
        if n <= c + c // 2:
            return c + c // 2
        c *= 2


def store_to_host(hi, lo, cnt):
    """Pull a store to host and strip sentinel slots -> (codes u64, counts).

    Host side may use uint64 freely (numpy, not device).
    """
    import numpy as np

    hi = np.asarray(hi, dtype=np.uint64)
    lo = np.asarray(lo, dtype=np.uint64)
    cnt = np.asarray(cnt)
    mask = cnt > 0
    codes = (hi[mask] << np.uint64(32)) | lo[mask]
    return codes, cnt[mask]


def merge_host_runs(runs):
    """G-way merge of sorted deduped (codes u64, counts) runs on host.

    Sums counts of equal codes across runs -> globally sorted distinct
    (codes u64, counts i64).  Uses the C heap merge (io/native.py
    fk_merge_runs, one pass) when available; numpy sort fallback
    otherwise."""
    import numpy as np

    runs = [(c, n) for c, n in runs if c.size]
    if not runs:
        return np.empty(0, np.uint64), np.empty(0, np.int64)
    if len(runs) == 1:
        c, n = runs[0]
        return c.astype(np.uint64, copy=False), n.astype(np.int64,
                                                         copy=False)
    from findkmer_tpu.io import native

    if native.available():
        if len(runs) <= 256:
            return native.merge_runs(runs)
        # hierarchical: C pass per 256-run chunk, then one final C pass
        # over the <= ceil(G/256) partials (row stores can now carry
        # more than 256 rows — ops/compaction.row_geometry)
        parts = [
            native.merge_runs(runs[i : i + 256])
            for i in range(0, len(runs), 256)
        ]
        return merge_host_runs(parts)
    codes = np.concatenate([c for c, _ in runs]).astype(np.uint64,
                                                        copy=False)
    cnts = np.concatenate([n for _, n in runs]).astype(np.int64,
                                                       copy=False)
    order = np.argsort(codes, kind="stable")
    codes = codes[order]
    cnts = cnts[order]
    starts = np.flatnonzero(
        np.concatenate([[True], codes[1:] != codes[:-1]])
    )
    return codes[starts], np.add.reduceat(cnts, starts)


def store_to_host_2d(hi, lo, cnt):
    """Row store (G, C) -> host (codes u64 sorted distinct, counts i64).

    Rows are independently sorted/deduped after compaction but may share
    codes; strip each row's holes and heap-merge the G runs
    (merge_host_runs).  `hi` may be None for narrow (k <= 15) stores."""
    import numpy as np

    lo = np.asarray(lo)
    cnt = np.asarray(cnt)
    hi = None if hi is None else np.asarray(hi)
    runs = []
    for g in range(lo.shape[0]):
        m = cnt[g] > 0
        if not m.any():
            continue
        # widen AFTER the strip: only live entries pay the uint64 copy
        codes = lo[g][m].astype(np.uint64)
        if hi is not None:
            codes |= hi[g][m].astype(np.uint64) << np.uint64(32)
        runs.append((codes, cnt[g][m]))
    return merge_host_runs(runs)
