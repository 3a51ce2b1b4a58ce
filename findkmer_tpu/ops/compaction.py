"""Shared row-store compaction machinery (single-chip + distributed).

The single-chip sparse engine (models/counter.py: a flat raw buffer
folded into a (G, cols) row store) and the dp_sparse distributed engine
(parallel/dist.py: (n_dev, cap) raw buffers folded into (n_dev*sub, L)
per-device sub-row stores) run the SAME compaction chain — row-wise
unstable sort + scan-RLE (ops/sparse.py), squeeze-to-live-ladder, and
on-demand cross-row dedup.  This module is the single parameterized
implementation both import (two near-copies once needed every
correctness fix twice).

Parameterization: every helper takes the TOTAL row count G of the store
(single-chip: the counter's geometry rows; distributed: n_dev * sub) and
the padded column target L as static arguments.  Raw buffers may arrive
in any shape whose size is divisible by G — the leading reshape is
row-major, so a sharded (n_dev, cap) buffer reshapes locally on each
device with zero cross-device movement.

Replaces (identically) the reference's count-structure insert/traverse
(SURVEY.md §2.1 R4) for large k; design rationale lives in the
ops/sparse.py module docstring.
"""

from __future__ import annotations

from functools import partial
from typing import Tuple

import jax
import jax.numpy as jnp
import numpy as np

from findkmer_tpu.ops import sparse as sparse_ops


def row_geometry(cap0: int, g0: int = 1, g_cap: int = 262144) -> int:
    """Row count of a sorted store over raw capacity cap0.

    More rows = shorter rows = fewer bitonic sort stages.  g_cap =
    262144 was tuned on the previous accelerator's bitonic sort and is
    not yet measured on the H100, whose sorts are radix sorts (ROADMAP
    S3/D5, bench/probe_rowsort2.py).  The cap0/128 guard below keeps
    test-scale stores at small G.  The result is a
    power of two that divides cap0 and every larger ladder capacity
    (buffers only grow; rows never change), kept <= cap0/128 so each
    row retains >= 128 raw slots for the per-row RLE.

    g0 is the caller's floor: the single-chip store starts at its
    STORE_ROWS=64 (also the per-pass cap of the C heap merge),
    the dp_sparse per-device SUB-row count starts at 1."""
    g = g0
    while g < g_cap and g * 256 <= cap0:
        g *= 2
    return g


@partial(jax.jit, static_argnames=("G", "L", "cdtype"), donate_argnums=(0,))
def compact_raw_rows(bufs, G: int, L: int, cdtype=jnp.int32):
    """First compaction (no store): raw code buffers -> row store.

    bufs: (lo,) or (hi, lo) SENT-masked raw code planes of any shape
    with size G*cols; each reshapes row-major to (G, cols), pads columns
    to L with sentinels, then one row-wise unstable sort + positional
    RLE.  Returns ((...planes..., cnt), per-row distinct (G,))."""
    bufs = tuple(b.reshape(G, -1) for b in bufs)
    pad = L - bufs[0].shape[1]
    if pad:
        bufs = tuple(
            jnp.concatenate(
                [b, jnp.full((G, pad), sparse_ops.sent_of(b.dtype),
                             b.dtype)],
                axis=1,
            )
            for b in bufs
        )
    if len(bufs) == 1:
        lo, cnt, d = sparse_ops.compact_raw_narrow_2d(bufs[0],
                                                      cdtype=cdtype)
        return (lo, cnt), d
    hi, lo, cnt, d = sparse_ops.compact_raw_2d(*bufs, cdtype=cdtype)
    return (hi, lo, cnt), d


@partial(jax.jit, static_argnames=("G", "L"), donate_argnums=(0, 1))
def compact_counted_rows(store, bufs, G: int, L: int):
    """Store-carrying compaction: store rows keep their counts, raw
    codes enter row-wise with count 1; one row sort + value-RLE.

    store: (lo, cnt) or (hi, lo, cnt) row planes of shape (G, Ls);
    bufs: raw code planes reshaped to (G, rawG); L is the padded COLUMN
    target (>= Ls + rawG).  The count dtype follows the store."""
    bufs = tuple(b.reshape(G, -1) for b in bufs)
    n_raw = bufs[0].shape[1]
    pad = L - store[0].shape[1] - n_raw
    cdt = store[-1].dtype
    ones = jnp.ones((G, n_raw), cdt)
    zpad = jnp.zeros((G, max(pad, 0)), cdt)

    def cat(s, b):
        parts = [s, b]
        if pad:
            parts.append(
                jnp.full((G, pad), sparse_ops.sent_of(b.dtype), b.dtype)
            )
        return jnp.concatenate(parts, axis=1)

    if len(bufs) == 1:
        lo = cat(store[0], bufs[0])
        cnt = jnp.concatenate([store[1], ones, zpad], axis=1)
        lo, cnt, d = sparse_ops.compact_counted_narrow_2d(lo, cnt)
        return (lo, cnt), d
    hi = cat(store[0], bufs[0])
    lo = cat(store[1], bufs[1])
    cnt = jnp.concatenate([store[2], ones, zpad], axis=1)
    hi, lo, cnt, d = sparse_ops.compact_counted_2d(hi, lo, cnt)
    return (hi, lo, cnt), d


def _squeeze_slice_impl(store, Ld: int):
    """Row-wise: sort zero-count holes to row ends, slice to Ld cols."""
    if len(store) == 2:
        lo, cnt = sparse_ops.squeeze_narrow_2d(*store)
        return lo[:, :Ld], cnt[:, :Ld]
    hi, lo, cnt = sparse_ops.squeeze_2d(*store)
    return hi[:, :Ld], lo[:, :Ld], cnt[:, :Ld]


# donating variant for compaction/table_state (old store dead there);
# finalize paths must NOT donate — the caller's state object stays valid
# after finalize (e.g. the scaling harness finalizes the same flushed
# state twice)
squeeze_slice = partial(
    jax.jit, static_argnames=("Ld",), donate_argnums=(0,)
)(_squeeze_slice_impl)
squeeze_slice_keep = partial(jax.jit, static_argnames=("Ld",))(
    _squeeze_slice_impl
)


def dedup_rows(
    store, D: int, sub: int, col_floor: int
) -> Tuple[tuple, int, np.ndarray]:
    """Cross-row dedup within D independent groups -> EXACT distinct.

    The row store keeps duplicates of a code that landed in several
    rows (up to sub copies per group), so the per-group entry sum can
    exceed true distinct on repeat-heavy input — up to G x at the 4096
    geometry (round-3 review finding).  Runs only when the entry sum
    crosses sparse_capacity: each group's rows concatenate (row-major
    reshape — local per device when groups are device shards), one flat
    per-group sort + value-RLE folds the duplicates, and the squeezed
    live prefix re-splits into `sub` contiguous sorted rows per group
    (contiguous chunks of a sorted array are themselves sorted disjoint
    rows, so finalize-without-recompaction stays exact).

    Single-chip: D=1, sub=G (the whole store is one group).
    dp_sparse:   D=n_dev, sub=per-device sub-rows.

    Returns (store2 with D*sub rows of Lc cols, Lc, per-row distinct
    (D*sub,) int64 on host)."""
    big = tuple(a.reshape(D, -1) for a in store)
    if len(big) == 3:
        out = sparse_ops.compact_counted_2d(*big)
        planes, d = out[:3], out[3]
    else:
        out = sparse_ops.compact_counted_narrow_2d(*big)
        planes, d = out[:2], out[2]
    dmax = int(np.asarray(d).max())
    Lc = sparse_ops.ladder(max(-(-dmax // sub), 1), floor=col_floor)
    planes = squeeze_slice_keep(planes, sub * Lc)
    store2 = tuple(a.reshape(D * sub, Lc) for a in planes)
    drows = np.asarray(
        jnp.count_nonzero(store2[-1], axis=1)
    ).astype(np.int64)
    return store2, Lc, drows
