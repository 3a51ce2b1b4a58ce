"""Device mesh construction (SURVEY.md §2.3 N6).

The engine uses a single 1-D mesh axis "d" over all chips: every chip is
both a data-parallel worker (counts its shard of rows) and — when the table
is sharded — the owner of one table shard (the EP-like key-routed layout of
SURVEY.md §2.2).  A separate 2-D (data, table) factorization buys nothing
for this workload: routing is all-to-all over all chips either way.  The
cards of one host are joined all to all (NVLink), so the mesh needs no
topology.
"""

from __future__ import annotations

from typing import Optional

import jax
import numpy as np
from jax.sharding import Mesh

AXIS = "d"


def device_axis() -> str:
    return AXIS


def make_mesh(n_devices: Optional[int] = None, devices=None) -> Mesh:
    """1-D mesh over `n_devices` (default: all available)."""
    if devices is None:
        devices = jax.devices()
    if n_devices is not None:
        if len(devices) < n_devices:
            raise ValueError(
                f"need {n_devices} devices, have {len(devices)}"
            )
        devices = devices[:n_devices]
    return Mesh(np.array(devices), (AXIS,))
