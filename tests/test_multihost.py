"""Multi-host input sharding logic (pure-function tests; SURVEY.md §4.2:
multi-host merge logic unit-tested without comms)."""

import numpy as np
import pytest

from conftest import random_dna
from findkmer_tpu.config import Config
from findkmer_tpu import pipeline
from findkmer_tpu.parallel.multihost import (
    initialize,
    local_device_ids_for,
    process_batch_count,
    shard_batches_round_robin,
)
from findkmer_tpu.models.counter import KmerCounter


def test_initialize_single_process_noop():
    assert initialize(None, 1, 0) == (1, 0)


@pytest.mark.parametrize("coord,environ,want", [
    ("127.0.0.1:1234", {}, [2]),          # one host: process i, card i
    ("localhost:1234", {}, [2]),
    ("10.0.0.7:1234", {}, None),          # across hosts: the launcher's
    ("127.0.0.1:1234", {"CUDA_VISIBLE_DEVICES": "3"}, None),  # choice
    ("127.0.0.1:1234", {"JAX_LOCAL_DEVICE_IDS": "3"}, None),
])
def test_one_card_per_process(coord, environ, want):
    assert local_device_ids_for(coord, 2, environ) == want


def test_round_robin_partition():
    batches = [np.full((1,), i, np.uint8) for i in range(10)]
    got = {
        pid: [b[0] for b in shard_batches_round_robin(iter(batches), 3, pid)]
        for pid in range(3)
    }
    assert got == {0: [0, 3, 6, 9], 1: [1, 4, 7], 2: [2, 5, 8]}
    assert process_batch_count(10, 3, 0) == 4
    assert process_batch_count(10, 3, 1) == 3
    assert process_batch_count(10, 3, 2) == 3


def test_simulated_hosts_merge_exact(rng, tmp_path):
    """P simulated hosts each count their round-robin batch share; the
    merged per-host spectra equal the single-host spectrum."""
    recs = [random_dna(rng, n, n_prob=0.02) for n in (2000, 1500, 900)]
    path = tmp_path / "in.fa"
    path.write_text("".join(f">r{i}\n{s}\n" for i, s in enumerate(recs)))

    cfg = Config(k=7, chunk_len=128, batch_rows=2)
    want = pipeline.count_file(str(path), cfg)

    P = 3
    total = np.zeros(4**cfg.k, np.int64)
    for pid in range(P):
        counter = KmerCounter(cfg)
        state = counter.init_state()
        for rows in shard_batches_round_robin(
            pipeline.batches_from_file(str(path), cfg), P, pid
        ):
            state = counter.step(state, rows)
        total += counter.finalize(state).astype(np.int64)
    np.testing.assert_array_equal(total, np.asarray(want).astype(np.int64))
