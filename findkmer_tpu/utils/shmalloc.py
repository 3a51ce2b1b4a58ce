"""Shared-memory numpy allocator loader (src/native/shmalloc.c).

On this class of lazily-backed VM, PRIVATE anonymous pages (normal
malloc/numpy memory) demand-fault through the hypervisor at ~17 MB/s
while SHARED anonymous pages fault at ~1.5 GB/s (measured on the
previous host VM; ROADMAP D10).  The C extension installs a numpy
PyDataMem handler that serves allocations >= 1 MiB from
MAP_SHARED|MAP_ANONYMOUS mmaps (with a small pooled free-list), which
covers every large host buffer in the engine — including the D2H
destination arrays np.asarray() creates when pulling device stores.

Best-effort: auto-builds with cc on first use, silently stays on the
default allocator if anything fails (correctness is unaffected).
Kill-switch: FINDKMER_NO_SHMALLOC=1.
"""

from __future__ import annotations

import os
import subprocess
import sys
from pathlib import Path

_REPO_ROOT = Path(__file__).resolve().parents[2]
_SRC_DIR = _REPO_ROOT / "src" / "native"
_installed = False
_attempted = False


def _build() -> bool:
    src = _SRC_DIR / "shmalloc.c"
    out = _SRC_DIR / "findkmer_shmalloc.so"
    if out.exists() and out.stat().st_mtime >= src.stat().st_mtime:
        return True
    if not src.exists():
        return False
    try:
        import numpy
        import sysconfig

        cc = os.environ.get("CC", "cc")
        cmd = [
            cc, "-O2", "-shared", "-fPIC", "-std=c11",
            f"-I{numpy.get_include()}",
            f"-I{sysconfig.get_paths()['include']}",
            str(src), "-o", str(out),
        ]
        res = subprocess.run(cmd, capture_output=True, timeout=120)
        return res.returncode == 0 and out.exists()
    except Exception:
        return False


def ensure_shared_alloc() -> bool:
    """Install the shared-memory numpy allocator (idempotent).

    Call EARLY — before the big host buffers of a run are allocated;
    already-allocated arrays keep their original allocator (numpy
    frees through the handler recorded per array, so mixing is safe).
    """
    global _installed, _attempted
    if _installed or _attempted:
        return _installed
    _attempted = True
    if os.environ.get("FINDKMER_NO_SHMALLOC") == "1":
        return False
    if not sys.platform.startswith("linux"):
        return False
    try:
        # installed (setup.py-built) extension, if present
        import findkmer_shmalloc
    except ImportError:
        if not _build():
            return False
        sp = str(_SRC_DIR)
        if sp not in sys.path:
            sys.path.insert(0, sp)
        try:
            import findkmer_shmalloc
        except Exception:
            return False
    try:
        _installed = bool(findkmer_shmalloc.install())
    except Exception:
        _installed = False
    return _installed


def stats():
    """(live shm blocks, shm bytes, pool hits) or None if not installed."""
    if not _installed:
        return None
    import findkmer_shmalloc

    return findkmer_shmalloc.stats()
