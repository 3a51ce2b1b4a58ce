"""glibc malloc tuning for the streaming hot path.

The batch pipeline allocates multi-MB buffers per batch.  glibc serves
those with mmap and munmaps them on free, so every batch refaults its
pages — catastrophic on lazily-backed VMs (first-touch ~0.02 GB/s on the
previous host VM; ROADMAP D10).  Raising M_MMAP_THRESHOLD makes malloc serve big
buffers from the reusable heap, keeping pages warm across batches.

Best-effort: silently does nothing on non-glibc platforms.
"""

from __future__ import annotations

import ctypes
import ctypes.util

_M_MMAP_THRESHOLD = -3
_M_TRIM_THRESHOLD = -1

_applied = False


def tune_for_streaming(mmap_threshold: int = 1 << 30) -> bool:
    """Keep allocations below `mmap_threshold` on the reusable heap.

    Returns True when the tuning took effect.  Idempotent.
    """
    global _applied
    if _applied:
        return True
    try:
        libc = ctypes.CDLL(ctypes.util.find_library("c") or "libc.so.6",
                           use_errno=True)
        ok1 = libc.mallopt(_M_MMAP_THRESHOLD, mmap_threshold)
        # never give heap pages back mid-stream
        ok2 = libc.mallopt(_M_TRIM_THRESHOLD, mmap_threshold)
        _applied = bool(ok1) and bool(ok2)
    except Exception:
        _applied = False
    return _applied
