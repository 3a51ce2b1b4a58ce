"""Count-table abstractions: dense (direct-addressed) and sparse stores.

The reference's count structure is a single in-memory 4^k array or 4-ary
trie (SURVEY.md §2.1 R4).  Here the table is a device-resident value with an
explicit mode and sharding story (SURVEY.md §2.3 N5):

  * DenseTable  — (4^k,) count vector in device memory, direct-addressed
    by window code.  k <= 16 hard cap;
    Config.direct_k_max soft cap for auto mode.
  * SparseTable — sorted (hi, lo, count) runs of static capacity for big k
    (ops/sparse.py), exact, no hashing.

Both are immutable-by-convention pytrees updated through the jitted step
functions in models/counter.py; .to_host() materializes the spectrum.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Tuple

import jax.numpy as jnp
import numpy as np

from findkmer_tpu.config import Config
from findkmer_tpu.ops import sparse as sparse_ops


@dataclass
class DenseTable:
    counts: jnp.ndarray  # (4^k,) int
    k: int

    @classmethod
    def zeros(cls, cfg: Config) -> "DenseTable":
        if cfg.k > 15:
            raise ValueError(f"dense table needs k <= 15, got {cfg.k}")
        dtype = jnp.dtype(cfg.count_dtype)
        return cls(counts=jnp.zeros((4 ** cfg.k,), dtype), k=cfg.k)

    def to_host(self) -> np.ndarray:
        return np.asarray(self.counts)

    def total(self) -> int:
        return int(self.counts.sum())


@dataclass
class SparseTable:
    hi: jnp.ndarray      # (cap,) uint16 (16<=k<=23) or uint32; all-ones
    #                      sentinel in empty slots (ops/sparse.hi_dtype)
    lo: jnp.ndarray      # (cap,) uint32
    cnt: jnp.ndarray     # (cap,) int32
    overflow: jnp.ndarray  # () bool — sticky overflow flag
    k: int

    def to_host(self) -> Tuple[np.ndarray, np.ndarray]:
        """(codes uint64 sorted ascending, counts) with sentinels stripped.

        Arrays may be flat sorted stores or (G, C) row stores (one
        sorted run per row; models/counter.py STORE_ROWS) — row stores
        are heap-merged on host."""
        if bool(self.overflow):
            raise RuntimeError(
                "sparse count store overflowed: distinct k-mers exceeded "
                "Config.sparse_capacity; rerun with a larger capacity"
            )
        if np.asarray(self.cnt).ndim == 2:
            return sparse_ops.store_to_host_2d(self.hi, self.lo, self.cnt)
        return sparse_ops.store_to_host(self.hi, self.lo, self.cnt)

    def total(self) -> int:
        return int(self.cnt.sum())


def make_table(cfg: Config) -> DenseTable:
    """Dense-mode table factory (sparse state is built by the engine's
    log-structured store in models/counter.py, not pre-allocated)."""
    assert cfg.resolved_table_mode == "direct", cfg.table_mode
    return DenseTable.zeros(cfg)
