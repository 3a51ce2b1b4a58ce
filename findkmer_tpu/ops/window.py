"""Rolling-window k-mer code extraction (XLA path).

Replacement for the reference findKmer's scan-loop inner iteration
(SURVEY.md §3.1 E2: `code = ((code << 2) | base) & mask` with a
validity run reset on non-ACGT bytes).  The branchy per-byte loop becomes k
static shifted slices OR'd together — fully vectorized, no
data-dependent control flow, jit-compiled once per (B, R) shape.

Input layout (set up by pipeline.py):
  rows: (B, R) uint8 codes in {0..3, INVALID=4}; R = L + k - 1 where the
  first k-1 slots are the halo (last bases of the previous chunk, or INVALID
  fill at stream start) and the remaining L slots are owned bases.

Output:
  W = R - k + 1 = L window codes per row.  Window i ends at owned position
  i, so each chunk owns exactly the windows ending inside it and no window
  is counted twice across chunk joints (SURVEY.md §5 long-context).

Two precisions:
  * window_codes       — k <= 15, single int32 code (< 2^30).
  * window_codes_wide  — 16 <= k <= 31, (hi, lo) uint32 pair; avoids x64
    (SURVEY.md §7 hard part 4: uint32-pair rolling update).

Canonical (reverse-complement-min) codes are built in the same pass: the
reverse complement needs the complement bases in reversed order, i.e.
rc = sum_j (3 - c[i+j]) << 2j, accumulated alongside the forward code.
"""

from __future__ import annotations

from functools import partial
from typing import Tuple

import jax
import jax.numpy as jnp
from jax import lax


def _slices(c: jnp.ndarray, k: int):
    """Yield the k shifted (B, W) slices of a (B, R) array."""
    W = c.shape[-1] - k + 1
    for j in range(k):
        yield lax.slice_in_dim(c, j, j + W, axis=-1)


@partial(jax.jit, static_argnames=("k", "canonical"))
def window_codes(
    rows: jnp.ndarray, k: int, canonical: bool = False
) -> Tuple[jnp.ndarray, jnp.ndarray]:
    """All window codes of each row.  k <= 15.

    Returns (codes int32 (B, W), valid bool (B, W)).  codes of invalid
    windows are arbitrary; mask with `valid`.
    """
    assert 1 <= k <= 15, k
    c = rows.astype(jnp.int32)
    code = None
    rc = None
    valid = None
    for j, cj in enumerate(_slices(c, k)):
        b = cj & 3
        v = cj < 4
        code = b if code is None else (code << 2) | b
        valid = v if valid is None else valid & v
        if canonical:
            r = (3 - b) << (2 * j)
            rc = r if rc is None else rc | r
    if canonical:
        code = jnp.minimum(code, rc)
    return code, valid


@partial(jax.jit, static_argnames=("k", "canonical"))
def window_codes_wide(
    rows: jnp.ndarray, k: int, canonical: bool = False
) -> Tuple[jnp.ndarray, jnp.ndarray, jnp.ndarray]:
    """All window codes of each row as (hi, lo) uint32 pairs.  16 <= k <= 31.

    The 2k-bit code is split as hi = code >> 32, lo = code & 0xffffffff.
    Rolling update per base (SURVEY.md §7 hard part 4):
        hi = (hi << 2) | (lo >> 30);  lo = (lo << 2) | base
    Returns (hi uint32 (B, W), lo uint32 (B, W), valid bool (B, W)).
    """
    assert 16 <= k <= 31, k
    c32 = rows.astype(jnp.uint32)
    hi = None
    lo = None
    valid = None
    rc_hi = None
    rc_lo = None
    for j, cj in enumerate(_slices(c32, k)):
        b = cj & jnp.uint32(3)
        v = cj < jnp.uint32(4)
        if lo is None:
            hi = jnp.zeros_like(b)
            lo = b
            valid = v
        else:
            hi = (hi << 2) | (lo >> 30)
            lo = (lo << 2) | b
            valid = valid & v
        if canonical:
            comp = jnp.uint32(3) - b
            if 2 * j < 32:
                r = comp << (2 * j)
                rc_lo = r if rc_lo is None else rc_lo | r
            else:
                r = comp << (2 * j - 32)
                rc_hi = r if rc_hi is None else rc_hi | r
    # mask hi to the 2k-32 meaningful bits (shifted-out bases drop off)
    hi_bits = 2 * k - 32
    hi = hi & jnp.uint32((1 << hi_bits) - 1)
    if canonical:
        if rc_hi is None:
            rc_hi = jnp.zeros_like(hi)
        rc_hi = rc_hi & jnp.uint32((1 << hi_bits) - 1)
        take_rc = (rc_hi < hi) | ((rc_hi == hi) & (rc_lo < lo))
        hi = jnp.where(take_rc, rc_hi, hi)
        lo = jnp.where(take_rc, rc_lo, lo)
    return hi, lo, valid


def unpack_rows(
    packed: jnp.ndarray, validbits: jnp.ndarray, R: int
) -> jnp.ndarray:
    """Device-side unpack of 2-bit-packed rows back to uint8 code rows.

    packed:    (B, R8/4) uint8, 4 bases/byte MSB-first within byte.
    validbits: (B, R8/8) uint8, 1 bit/base MSB-first (the wire is one
    big-endian bitstream; see src/native/encode.c).
    Returns (B, R) uint8 codes with INVALID (4) at invalid positions.
    Pure VPU shifts; XLA fuses this into the window extraction, so the
    packed H2D format costs no extra memory pass.
    """
    B = packed.shape[0]
    shifts2 = jnp.arange(6, -1, -2, dtype=jnp.uint8)
    codes = (
        (packed[:, :, None] >> shifts2[None, None, :]) & jnp.uint8(3)
    ).reshape(B, -1)
    shifts1 = jnp.arange(7, -1, -1, dtype=jnp.uint8)
    bits = (
        (validbits[:, :, None] >> shifts1[None, None, :]) & jnp.uint8(1)
    ).reshape(B, -1)
    rows = jnp.where(bits == 1, codes, jnp.uint8(4))
    return rows[:, :R]


def _be_words32(b: jnp.ndarray, pad_words: int) -> jnp.ndarray:
    """(B, NB) uint8 -> (B, NW+pad) big-endian uint32 words.

    bitcast (little-endian) + elementwise byteswap instead of strided
    byte slices (b[:, 0::4])."""
    B, NB = b.shape
    padb = (-NB) % 4 + 4 * pad_words
    if padb:
        b = jnp.concatenate(
            [b, jnp.zeros((B, padb), jnp.uint8)], axis=1
        )
    le = lax.bitcast_convert_type(
        b.reshape(B, -1, 4), jnp.uint32
    )
    m8 = jnp.uint32(0xFF)
    m16 = jnp.uint32(0xFF00)
    return (
        ((le & m8) << 24)
        | ((le & m16) << 8)
        | ((le >> 8) & m16)
        | (le >> 24)
    )


def _be_half16(v: jnp.ndarray, pad_halves: int) -> jnp.ndarray:
    """(B, NV) uint8 validmask -> (B, NH+pad) 16-bit halfwords (uint32)."""
    B, NV = v.shape
    padb = (-NV) % 2 + 2 * pad_halves
    if padb:
        v = jnp.concatenate(
            [v, jnp.zeros((B, padb), jnp.uint8)], axis=1
        )
    le = lax.bitcast_convert_type(
        v.reshape(B, -1, 2), jnp.uint16
    ).astype(jnp.uint32)
    return ((le & jnp.uint32(0xFF)) << 8) | (le >> 8)


def _rev32_2bit(x: jnp.ndarray) -> jnp.ndarray:
    """Reverse the 16 2-bit groups of each uint32."""
    m2 = jnp.uint32(0x33333333)
    m4 = jnp.uint32(0x0F0F0F0F)
    x = ((x & m2) << 2) | ((x >> 2) & m2)
    x = ((x & m4) << 4) | ((x >> 4) & m4)
    return (
        ((x & jnp.uint32(0xFF)) << 24)
        | ((x & jnp.uint32(0xFF00)) << 8)
        | ((x >> 8) & jnp.uint32(0xFF00))
        | (x >> 24)
    )


@partial(jax.jit, static_argnames=("k", "canonical", "R"))
def window_codes_packed(
    packed: jnp.ndarray, validbits: jnp.ndarray, k: int,
    canonical: bool = False, R: int = 0,
):
    """Window codes straight from the packed 2-bit wire format.

    The wire is a big-endian 2-bit stream (src/native/encode.c), so a
    32-bit word holds 16 bases and the code of the window starting at
    base p = 16w + r is two shifted combines of words w, w+1, w+2 at a
    CONSTANT shift 2r — 16 residue streams replace the k-slice OR chain
    of window_codes (~1 op/window vs ~4k).  Validity rides the same scheme on
    16-bit halfwords of the validity bitstream.

    Returns FLAT SENT-masked arrays in residue-interleaved order —
    callers must be order-invariant (the sparse sort path is; counting
    is a multiset operation).  k <= 15 -> (lo,); k >= 16 -> (hi, lo).
    Slots beyond the last complete window come out SENT via the zero
    validity padding, so no explicit bounds masking is needed.

    R (static) is the true row length in bases; when given, the word
    streams are truncated to ceil((R-k+1)/16) so the emitted slot count
    matches the row's window count to within 15 — without it the byte
    padding adds ~32 all-SENT slots/row, enough to push an exactly
    pre-sized raw buffer over capacity and double the compaction sort.
    """
    assert 1 <= k <= 31
    SENT = jnp.uint32(0xFFFFFFFF)
    W32 = _be_words32(packed, 2)          # (B, NW+2)
    V16 = _be_half16(validbits, 2)        # (B, NH+2)
    NW = W32.shape[1] - 2
    if R:
        NW = min(NW, (max(R - k + 1, 0) + 15) // 16)
    W0 = W32[:, :NW]
    W1 = W32[:, 1 : NW + 1]
    W2 = W32[:, 2 : NW + 2]
    w_valid = (1 << k) - 1
    outs = []
    for r in range(16):
        s = 2 * r
        if s:
            a = (W0 << s) | (W1 >> (32 - s))
            b2 = (W1 << s) | (W2 >> (32 - s))
        else:
            a, b2 = W0, W1
        # validity: top k bits of the bitstream starting at base 16w+r
        C32 = (V16[:, :NW] << 16) | V16[:, 1 : NW + 1]
        t = (C32 << r) | (V16[:, 2 : NW + 2] >> (16 - r)) if r else C32
        valid = (t >> (32 - k)) == w_valid
        if k <= 15:
            lo = a >> (32 - 2 * k)
            if canonical:
                rc = _rev32_2bit(~lo) >> (32 - 2 * k)
                lo = jnp.minimum(lo, rc)
            outs.append((jnp.where(valid, lo, SENT),))
        else:
            if k == 16:
                hi = jnp.zeros_like(a)
                lo = a
            else:
                hi = a >> (64 - 2 * k)
                lo = (a << (2 * k - 32)) | (b2 >> (64 - 2 * k))
            if canonical:
                himask = jnp.uint32((1 << (2 * k - 32)) - 1)
                U = _rev32_2bit(~lo)          # high word of rev64
                V = _rev32_2bit(~hi)          # low word of rev64
                sh = 64 - 2 * k
                if sh == 32:
                    rc_hi = jnp.zeros_like(U)
                    rc_lo = U
                else:
                    rc_hi = U >> sh
                    rc_lo = (V >> sh) | (U << (32 - sh))
                rc_hi = rc_hi & himask
                take = (rc_hi < hi) | ((rc_hi == hi) & (rc_lo < lo))
                hi = jnp.where(take, rc_hi, hi)
                lo = jnp.where(take, rc_lo, lo)
            outs.append(
                (jnp.where(valid, hi, SENT), jnp.where(valid, lo, SENT))
            )
    n_arr = len(outs[0])
    return tuple(
        jnp.stack([o[i] for o in outs]).reshape(-1) for i in range(n_arr)
    )


def rows_from_batch(batch, R: int) -> jnp.ndarray:
    """Accept either raw (B, R) uint8 rows or a (packed, validbits) pair."""
    if isinstance(batch, (tuple, list)):
        packed, validbits = batch
        return unpack_rows(packed, validbits, R)
    return batch


def revcomp_code(code: int, k: int) -> int:
    """Host-side reverse complement of an integer k-mer code (tests/output)."""
    rc = 0
    for _ in range(k):
        rc = (rc << 2) | (3 - (code & 3))
        code >>= 2
    return rc


def code_to_str(code: int, k: int) -> str:
    """Host-side code -> ACGT string (lexicographic order == numeric)."""
    bases = "ACGT"
    return "".join(bases[(code >> (2 * (k - 1 - j))) & 3] for j in range(k))


def str_to_code(kmer: str) -> int:
    m = {"A": 0, "C": 1, "G": 2, "T": 3}
    code = 0
    for ch in kmer.upper():
        code = (code << 2) | m[ch]
    return code
