"""Dense count-table accumulation (k <= ~15, direct-addressed 4^k table).

Replacement for the reference's count-insert (SURVEY.md §3.1 E3:
`counts[code]++` / trie walk).  A per-byte random RMW becomes one of several
batched, exact device algorithms, selected by Config.hist (`resolve_method`
maps HIST_AUTO to one of them by k):

  * scatter — one `table.at[codes].add(1)` over the whole batch (atomic
    adds on a GPU); simple, exact, the general-purpose path.
  * sort    — sort the batch's codes, run-length-encode, scatter only the
    distinct codes' run lengths.  Fewer RMWs when codes repeat; also the
    deterministic cross-check for every other path (the de-facto race
    detector, SURVEY.md §5).
  * onehot  — a 2-level radix histogram done as one int8 outer product per
    tile: the code splits into (hi, lo) halves and
    acc[hi, lo] += onehot_hi^T @ onehot_lo, an integer GEMM with int32
    accumulation.  Contention-free, but its work grows as 4^(k/2) per
    window; only sensible for small k.

All paths route invalid windows to a trash bin at index 4^k so the compute
is branch-free; the trash bin is dropped before results are read.
"""

from __future__ import annotations

from functools import partial
import jax
import jax.numpy as jnp
from jax import lax

from findkmer_tpu.config import HIST_AUTO, HIST_ONEHOT, HIST_SCATTER

# k for which `auto` picks a method other than scatter.  Measured with
# bench/hist_sweep.py on an NVIDIA H100 80GB HBM3 (700 W limit), dense
# step at the CLI's 256 x 65536 geometry, median of 5 x 10 steps: onehot
# beats scatter's atomics, which contend on few bins, for k <= 4 (k=4:
# 1.50 ms against 2.11-4.31 ms); scatter wins from k=5 (k=8: 0.32 ms
# against onehot's 20.5 ms); sort is never faster (15-37 ms).  CHANGES.md
# and PERF.md have the full table.
_AUTO_OVERRIDES = {k: HIST_ONEHOT for k in range(1, 5)}


def resolve_method(method: str, k: int) -> str:
    """Config.hist (validated by Config) -> the dense accumulation
    method that runs for k."""
    if method == HIST_AUTO:
        return _AUTO_OVERRIDES.get(k, HIST_SCATTER)
    return method


def _flat_codes(codes: jnp.ndarray, valid: jnp.ndarray, table_size: int):
    """Flatten (B, W) codes, sending invalid windows to the trash bin."""
    idx = jnp.where(valid, codes, table_size)
    return idx.reshape(-1)


@partial(jax.jit, static_argnames=("table_size",), donate_argnums=(2,))
def add_counts_scatter(
    codes: jnp.ndarray, valid: jnp.ndarray, table: jnp.ndarray, table_size: int
) -> jnp.ndarray:
    """table (4^k,) += histogram(codes[valid]) via XLA scatter-add."""
    idx = _flat_codes(codes, valid, table_size)
    # invalid windows carry the OOB index table_size -> dropped by the
    # scatter, so no table-sized padding copy is needed
    return table.at[idx].add(1, mode="drop")


@partial(jax.jit, static_argnames=("table_size",), donate_argnums=(2,))
def add_counts_sort(
    codes: jnp.ndarray, valid: jnp.ndarray, table: jnp.ndarray, table_size: int
) -> jnp.ndarray:
    """table += histogram via sort + run-length + sparse scatter.

    Deterministic reduction order; used as the cross-check oracle for the
    scatter and onehot paths in tests.
    """
    idx = jnp.sort(_flat_codes(codes, valid, table_size))
    n = idx.shape[0]
    # run starts: first element of each equal-code run
    prev = jnp.concatenate([jnp.full((1,), -1, idx.dtype), idx[:-1]])
    is_start = idx != prev
    # run id of each element; run_count = segment length
    run_id = jnp.cumsum(is_start) - 1
    run_len = jax.ops.segment_sum(
        jnp.ones_like(idx), run_id, num_segments=n
    )
    # code of each run: scatter idx at starts into run slots
    run_code = jnp.zeros((n,), idx.dtype).at[run_id].max(idx)
    # add run lengths at their codes (runs beyond the distinct count have
    # run_len 0 and run_code 0 -> adding 0 is harmless; the trash-bin run
    # carries the OOB code table_size and is dropped)
    return table.at[run_code].add(run_len.astype(table.dtype), mode="drop")


# one-hot bytes per onehot tile: bounds the (chunk, T1 + T2) int8 operands
_ONEHOT_TILE_BYTES = 1 << 26


def onehot_split(table_size: int):
    """(T1, T2), T2 a power of two and T1 * T2 >= table_size (equal for
    a 4^k table): the code's hi/lo radix split, balanced so each window
    costs T1 + T2 one-hot bytes."""
    lo_bits = table_size.bit_length() // 2
    return -(-table_size // (1 << lo_bits)), 1 << lo_bits


@partial(jax.jit, static_argnames=("table_size", "chunk"), donate_argnums=(2,))
def add_counts_onehot(
    codes: jnp.ndarray,
    valid: jnp.ndarray,
    table: jnp.ndarray,
    table_size: int,
    chunk: int = 0,
) -> jnp.ndarray:
    """table += histogram via an int8 outer product per tile.

    Each code splits into hi = code // T2 and lo = code % T2, and

        acc[hi, lo] += sum_n onehot_hi[n, hi] * onehot_lo[n, lo]

    is one (T1, chunk) x (chunk, T2) integer GEMM with int32
    accumulation, scanned over tiles of `chunk` windows (0 = sized so a
    tile's one-hots take about 64 MiB).  Invalid windows get an all-zero
    hi row and so add nothing.
    """
    T1, T2 = onehot_split(table_size)
    lo_bits = T2.bit_length() - 1
    flat = codes.reshape(-1).astype(jnp.int32)
    ok = valid.reshape(-1)
    n = flat.shape[0]
    if chunk <= 0:
        chunk = max(256, _ONEHOT_TILE_BYTES // (T1 + T2))
    chunk = min(chunk, -(-n // 8) * 8)
    pad = (-n) % chunk
    if pad:
        flat = jnp.concatenate([flat, jnp.zeros((pad,), flat.dtype)])
        ok = jnp.concatenate([ok, jnp.zeros((pad,), ok.dtype)])
    hi_tiles = jnp.where(ok, flat >> lo_bits, T1).reshape(-1, chunk)
    lo_tiles = (flat & (T2 - 1)).reshape(-1, chunk)

    def tile_counts(hi, lo):
        oh_hi = (hi[:, None] == lax.iota(jnp.int32, T1)).astype(jnp.int8)
        oh_lo = (lo[:, None] == lax.iota(jnp.int32, T2)).astype(jnp.int8)
        return lax.dot_general(
            oh_hi, oh_lo,
            dimension_numbers=(((0,), (0,)), ((), ())),
            preferred_element_type=jnp.int32,
        )

    # the first tile seeds the carry, so under shard_map it varies over
    # the mesh axis like every later tile's sum
    acc = tile_counts(hi_tiles[0], lo_tiles[0])
    if hi_tiles.shape[0] > 1:
        acc, _ = lax.scan(
            lambda acc, t: (acc + tile_counts(*t), None),
            acc, (hi_tiles[1:], lo_tiles[1:]),
        )
    return table + acc.reshape(-1)[:table_size].astype(table.dtype)


_DENSE_FNS = {
    "scatter": add_counts_scatter,
    "sort": add_counts_sort,
    "onehot": add_counts_onehot,
}


def dense_counts(
    codes: jnp.ndarray,
    valid: jnp.ndarray,
    table: jnp.ndarray,
    table_size: int,
    method: str = "scatter",
) -> jnp.ndarray:
    """Dispatch to a dense accumulation method by its resolved name
    (resolve_method)."""
    return _DENSE_FNS[method](codes, valid, table, table_size)


@partial(jax.jit, static_argnames=("table_size",))
def histogram(codes: jnp.ndarray, valid: jnp.ndarray, table_size: int):
    """Fresh histogram (no accumulation) — convenience for tests."""
    table = jnp.zeros((table_size,), jnp.int32)
    return add_counts_scatter(codes, valid, table, table_size)
