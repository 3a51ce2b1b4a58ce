"""Multi-process orchestration (SURVEY.md §2.2 communication backend, §3.2 F2).

Process-group story: `jax.distributed.initialize()` bootstraps the group,
then every data-plane collective is an XLA op inside the jitted counting
step (parallel/dist.py), which XLA hands to NCCL on GPUs.

One process per card: a JAX process reserves most of a card's memory when
it first uses it, so two processes on one card fail.  A group whose
coordinator is on the loopback address runs on one host, so process i
takes local card i (`local_device_ids`).  A group across hosts launches
each process with CUDA_VISIBLE_DEVICES (or JAX_LOCAL_DEVICE_IDS) naming
its cards.

Host-side input sharding: host h streams batches h, h+P, h+2P, ... of the
deterministic global batch sequence (round-robin), so no coordination is
needed beyond the initial process index.  Each host feeds only its local
devices via jax.make_array_from_process_local_data; the final merge is the
same collective finalize as single-host.

This box has one host (SURVEY.md §7: multi-host left runnable via flags);
the logic below is exercised in tests by simulating P hosts in one process
(round-robin splitting is a pure function of (batch_index, P)).
"""

from __future__ import annotations

import os
from typing import Iterator, Optional

import numpy as np


def initialize(
    coordinator_address: Optional[str] = None,
    num_processes: Optional[int] = None,
    process_id: Optional[int] = None,
):
    """jax.distributed bootstrap; no-op for single-process runs.

    Arguments default from the standard env vars
    (FINDKMER_COORDINATOR/NUM_PROCESSES/PROCESS_ID) so a launcher can
    export instead of passing flags.  Card assignment: see
    local_device_ids_for.
    """
    import jax

    coordinator_address = coordinator_address or os.environ.get(
        "FINDKMER_COORDINATOR"
    )
    if num_processes is None:
        num_processes = int(os.environ.get("FINDKMER_NUM_PROCESSES", "1"))
    if process_id is None:
        process_id = int(os.environ.get("FINDKMER_PROCESS_ID", "0"))
    if num_processes <= 1:
        return 1, 0
    if not (0 <= process_id < num_processes):
        raise ValueError(
            f"process_id {process_id} out of range for {num_processes} "
            "processes"
        )
    # Without a coordinator the hosts run independently (file-level merge
    # via `findkmer merge`); with one, jax.distributed gives a global
    # device mesh for collective merging (parallel/dist.py).
    if coordinator_address is not None:
        jax.distributed.initialize(
            coordinator_address=coordinator_address,
            num_processes=num_processes,
            process_id=process_id,
            local_device_ids=local_device_ids_for(
                coordinator_address, process_id, os.environ
            ),
        )
    return num_processes, process_id


_LOOPBACK = ("localhost", "127.", "[::1]", "::1")


def local_device_ids_for(coordinator_address: str, process_id: int,
                         environ) -> Optional[list]:
    """The local card a group process takes: [process_id] when the
    coordinator is on the loopback address (every process is on this
    host), else None.  A launcher's own choice (CUDA_VISIBLE_DEVICES or
    JAX_LOCAL_DEVICE_IDS) always wins."""
    if "CUDA_VISIBLE_DEVICES" in environ or "JAX_LOCAL_DEVICE_IDS" in environ:
        return None
    if coordinator_address.startswith(_LOOPBACK):
        return [process_id]
    return None


def shard_batches_round_robin(
    batches: Iterator[np.ndarray], num_processes: int, process_id: int
) -> Iterator[np.ndarray]:
    """Deterministic host-side input sharding: host h takes batch indices
    congruent to h mod P.  Pure function of the global batch sequence, so
    hosts need no coordination and resume composes (streaming.py)."""
    for i, b in enumerate(batches):
        if i % num_processes == process_id:
            yield b


def process_batch_count(total_batches: int, num_processes: int,
                        process_id: int) -> int:
    """How many batches the given host processes out of `total_batches`."""
    return (total_batches - process_id + num_processes - 1) // num_processes


def group_active() -> bool:
    """True when a jax.distributed process group with >1 host is up."""
    import jax

    try:
        return jax.process_count() > 1
    except Exception:
        return False


def allgather_spectrum(spectrum):
    """Collective finalize across a jax.distributed group: every host
    contributes its PARTIAL spectrum, every host returns with the FULL
    merged one.  One allgather replaces the per-host-TSV +
    `findkmer merge` tail (round-1 verdict item 4; BASELINE metric 2).

    Dense partials (np (4^k,) arrays) sum; sparse partials
    ((codes uint64, counts)) are sentinel-padded to the group max
    length, gathered, and merged on the host (per-host partials are
    sorted distinct runs, so the merge is one heap pass —
    sparse_ops.merge_host_runs).
    """
    import numpy as np
    from jax.experimental import multihost_utils

    if not group_active():
        return spectrum

    if not isinstance(spectrum, tuple):  # dense partial table
        total = multihost_utils.process_allgather(
            np.asarray(spectrum), tiled=False
        )
        return np.asarray(total).sum(axis=0)

    codes, counts = spectrum
    codes = np.ascontiguousarray(codes, dtype=np.uint64)
    counts = np.ascontiguousarray(counts, dtype=np.int64)
    n_local = np.array([codes.size], dtype=np.int32)
    lengths = np.asarray(multihost_utils.process_allgather(n_local))
    L = int(lengths.max())
    pad = L - codes.size
    if pad:
        codes = np.concatenate([codes, np.zeros(pad, np.uint64)])
        counts = np.concatenate([counts, np.zeros(pad, np.int64)])
    # 64-bit values must cross the collective as uint32 pairs: without
    # x64 enabled jax silently truncates u64/i64 arrays to 32 bits
    def _gather64(a: np.ndarray) -> np.ndarray:
        pairs = a.view(np.uint32).reshape(-1, 2)
        out = np.asarray(multihost_utils.process_allgather(pairs))
        return out.reshape(-1, 2).copy().view(np.uint64).reshape(-1)

    P = lengths.size
    all_codes = _gather64(codes).reshape(P, L)
    all_counts = _gather64(counts.view(np.uint64)).view(np.int64)
    all_counts = all_counts.reshape(P, L)
    from findkmer_tpu.ops import sparse as sparse_ops

    runs = []
    for p in range(P):
        c = all_codes[p, : int(lengths[p])]
        n = all_counts[p, : int(lengths[p])]
        m = n > 0
        runs.append((c[m], n[m]))
    # per-host partials are sorted distinct runs -> one heap-merge pass
    return sparse_ops.merge_host_runs(runs)
