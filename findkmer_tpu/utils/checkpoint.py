"""Checkpoint/resume for streaming counts (SURVEY.md §5).

The reference recomputes from scratch on any failure; here the pipeline
persists (config, batch index, stream stats, count-table state) every N
batches.  Counting is associative and the batch stream is deterministic
given (config, inputs), so resuming from the last checkpoint and skipping
already-counted batches reproduces bit-identical spectra — the fault
tolerance story for chr1-scale multi-hour streams [BASELINE config 5].

Format: one .npz per checkpoint + a JSON "latest" pointer; atomic via
rename.  No RNG state exists anywhere in the engine, so checkpoints are
trivially exact.
"""

from __future__ import annotations

import json
import os
import tempfile
from pathlib import Path
from typing import Optional, Tuple

import numpy as np

from findkmer_tpu.config import Config
from findkmer_tpu import table as table_mod


def save(
    ckpt_dir, cfg: Config, batch_index: int, state, stats_dict: dict,
    extra: Optional[dict] = None,
) -> Path:
    """extra: small JSON-able side state recorded in the manifest —
    e.g. {"spill_runs": N}, the number of disk-spill run files that
    belong to this checkpoint's prefix (spill runs are atomic sorted
    artifacts outside the npz; see streaming.py)."""
    d = Path(ckpt_dir)
    d.mkdir(parents=True, exist_ok=True)
    arrays = {}
    if isinstance(state, table_mod.DenseTable):
        arrays["counts"] = np.asarray(state.counts)
        mode = "direct"
    else:
        arrays["hi"] = np.asarray(state.hi)
        arrays["lo"] = np.asarray(state.lo)
        arrays["cnt"] = np.asarray(state.cnt)
        arrays["overflow"] = np.asarray(state.overflow)
        mode = "sparse"

    path = d / f"ckpt_{batch_index:010d}.npz"
    tmp_fd, tmp_name = tempfile.mkstemp(dir=str(d), suffix=".tmp")
    try:
        with os.fdopen(tmp_fd, "wb") as f:
            np.savez_compressed(f, **arrays)
        os.replace(tmp_name, path)
    except BaseException:
        if os.path.exists(tmp_name):
            os.unlink(tmp_name)
        raise

    meta = {
        "config": json.loads(cfg.to_json()),
        "batch_index": batch_index,
        "stats": stats_dict,
        "mode": mode,
        "file": path.name,
        "extra": extra or {},
    }
    tmp = d / "latest.json.tmp"
    tmp.write_text(json.dumps(meta))
    os.replace(tmp, d / "latest.json")
    return path


def load_latest(
    ckpt_dir, cfg: Config
) -> Optional[Tuple[int, object, dict, dict]]:
    """Return (batch_index, state, stats_dict, extra) or None if no
    checkpoint.

    Raises if the checkpoint's config is incompatible (different k,
    canonical, table mode, or batch geometry — resuming under different
    semantics would silently corrupt counts).
    """
    d = Path(ckpt_dir)
    meta_path = d / "latest.json"
    if not meta_path.exists():
        return None
    meta = json.loads(meta_path.read_text())
    saved_cfg = Config(**meta["config"])
    for field in (
        "k", "canonical", "chunk_len", "batch_rows",
        "sparse_capacity", "count_dtype",
    ):
        if getattr(saved_cfg, field) != getattr(cfg, field):
            raise ValueError(
                f"checkpoint config mismatch on {field!r}: "
                f"{getattr(saved_cfg, field)} != {getattr(cfg, field)}"
            )
    # table_mode compares RESOLVED (auto vs an explicit spelling of the
    # same mode is compatible); devices/merge are deliberately NOT
    # checked — checkpoints are elastic across mesh width and merge
    # strategy (parallel/dist.py restore_state)
    if saved_cfg.resolved_table_mode != cfg.resolved_table_mode:
        raise ValueError(
            f"checkpoint config mismatch on table mode: "
            f"{saved_cfg.resolved_table_mode} != {cfg.resolved_table_mode}"
        )
    data = np.load(d / meta["file"])
    # tables stay HOST-side (numpy): every restore_state re-deals or
    # re-shards them anyway, so a jnp.asarray here would push a
    # chr-scale store H2D only for restore to pull it straight back
    # (2x the store over PCIe on every resume).  The direct-mode
    # single-chip restore converts to device itself.
    if meta["mode"] == "direct":
        state = table_mod.DenseTable(counts=data["counts"], k=cfg.k)
    else:
        state = table_mod.SparseTable(
            hi=data["hi"],
            lo=data["lo"],
            cnt=data["cnt"],
            overflow=data["overflow"],
            k=cfg.k,
        )
    return meta["batch_index"], state, meta.get("stats", {}), \
        meta.get("extra", {})
