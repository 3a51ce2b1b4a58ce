"""Distributed counting on the 8-virtual-CPU-device mesh
(SURVEY.md §4.2: multi-device logic without a cluster)."""

import io

import numpy as np
import jax
import pytest

from conftest import random_dna
from findkmer_tpu.config import Config
from findkmer_tpu.io.fasta import FastaReader
from findkmer_tpu import pipeline
from findkmer_tpu.parallel import DistributedCounter, make_mesh
from test_vs_oracle import oracle_dict, spectrum_to_dict


def _count_dist(text, cfg, n_dev):
    mesh = make_mesh(n_dev)
    dc = DistributedCounter(cfg, mesh)
    state = dc.init_state()
    reader = FastaReader(io.BytesIO(text.encode()))
    for rows in pipeline.batches_from_codes(
        pipeline.code_stream(reader), cfg
    ):
        state = dc.step(state, rows)
    return dc.finalize(state)


def test_eight_devices_present():
    assert len(jax.devices()) == 8


@pytest.mark.parametrize("n_dev", [1, 2, 8])
@pytest.mark.parametrize("merge", ["psum", "all_to_all"])
def test_dense_dist_matches_oracle(rng, n_dev, merge):
    seq = random_dna(rng, 4000, n_prob=0.03)
    text = ">r\n" + seq + "\n"
    cfg = Config(k=8, chunk_len=64, batch_rows=8, merge=merge)
    spectrum = _count_dist(text, cfg, n_dev)
    assert spectrum_to_dict(np.asarray(spectrum), 8) == oracle_dict(text, 8)


@pytest.mark.parametrize("n_dev", [2, 8])
def test_sparse_dist_matches_oracle(rng, n_dev):
    seq = random_dna(rng, 3000, n_prob=0.02)
    text = ">r\n" + seq + "\n"
    cfg = Config(
        k=21, chunk_len=64, batch_rows=8, sparse_capacity=8192,
    )
    spectrum = _count_dist(text, cfg, n_dev)
    assert spectrum_to_dict(spectrum, 21) == oracle_dict(text, 21)


def test_all_to_all_k11_sharded_table(rng):
    """Representative-k sharded-table route (VERDICT round 1): 4^11 = 4M
    entries split 8 ways exercises shard-size/route arithmetic that the
    k=8 cases (table < route width) cannot."""
    seq = random_dna(rng, 6000, n_prob=0.02)
    text = ">r\n" + seq + "\n"
    cfg = Config(
        k=11, chunk_len=64, batch_rows=8, merge="all_to_all",
        table_mode="direct",
    )
    spectrum = _count_dist(text, cfg, 8)
    assert spectrum_to_dict(np.asarray(spectrum), 11) == oracle_dict(
        text, 11
    )


def test_all_to_all_canonical(rng):
    seq = random_dna(rng, 2000)
    text = ">r\n" + seq + "\n"
    cfg = Config(
        k=8, canonical=True, chunk_len=64, batch_rows=8, merge="all_to_all"
    )
    spectrum = _count_dist(text, cfg, 4)
    assert spectrum_to_dict(np.asarray(spectrum), 8) == oracle_dict(
        text, 8, canonical=True
    )


def test_route_overflow_detected(rng):
    # extreme skew: poly-A stream routes everything to shard 0
    text = ">r\n" + "A" * 4000 + "\n"
    cfg = Config(
        k=8, chunk_len=64, batch_rows=8, merge="all_to_all",
        route_capacity_factor=0.01,
    )
    with pytest.raises(RuntimeError, match="overflow"):
        _count_dist(text, cfg, 8)


def test_dist_matches_single_device_engine(rng):
    seq = random_dna(rng, 5000, n_prob=0.05)
    text = ">r\n" + seq + "\n"
    cfg = Config(k=6, chunk_len=128, batch_rows=8)
    from test_vs_oracle import count_text

    single, _ = count_text(text, cfg)
    multi = _count_dist(text, cfg.replace(merge="psum"), 8)
    np.testing.assert_array_equal(np.asarray(single), np.asarray(multi))


@pytest.mark.parametrize("n_dev", [2, 8])
def test_psum_scatter_equals_psum(rng, n_dev):
    """Reduce-scatter merge == all-reduce merge == oracle (VERDICT item:
    implement psum_scatter or delete the constant)."""
    seq = random_dna(rng, 4000, n_prob=0.03)
    text = ">r\n" + seq + "\n"
    base = Config(k=7, chunk_len=64, batch_rows=8)
    s_ps = _count_dist(text, base.replace(merge="psum"), n_dev)
    s_rs = _count_dist(text, base.replace(merge="psum_scatter"), n_dev)
    np.testing.assert_array_equal(np.asarray(s_ps), np.asarray(s_rs))
    assert spectrum_to_dict(np.asarray(s_rs), 7) == oracle_dict(text, 7)


def test_all_to_all_k11_eight_shards(rng):
    """Config-3 route arithmetic at representative k: 4^11 = 4M-entry
    table sharded 8 ways, key-routed all_to_all (VERDICT missing #5)."""
    seq = random_dna(rng, 6000, n_prob=0.02)
    text = ">r\n" + seq + "\n"
    cfg = Config(k=11, chunk_len=128, batch_rows=8, merge="all_to_all",
                 table_mode="direct")
    spectrum = _count_dist(text, cfg, 8)
    got = spectrum_to_dict(np.asarray(spectrum), 11)
    assert got == oracle_dict(text, 11)


def test_make_counter_devices(rng):
    """make_counter routes devices=1 to the single-device engine and
    devices>1 to the mesh; both match the oracle."""
    from findkmer_tpu.models.counter import KmerCounter, make_counter
    from findkmer_tpu.parallel.dist import DistributedCounter

    assert isinstance(make_counter(Config(k=4)), KmerCounter)
    dc = make_counter(Config(k=4, devices=8))
    assert isinstance(dc, DistributedCounter)
    dc0 = make_counter(Config(k=4, devices=0))
    assert isinstance(dc0, DistributedCounter)
    assert dc0.n_dev == 8


def test_route_overflow_fails_fast(rng):
    """Skewed input must error within overflow_check_every batches, not
    at finalize (round-2 advisor finding)."""
    text = ">r\n" + "A" * 40000 + "\n"
    cfg = Config(k=8, chunk_len=64, batch_rows=8, merge="all_to_all",
                 route_capacity_factor=0.01)
    mesh = make_mesh(8)
    dc = DistributedCounter(cfg, mesh)
    dc.overflow_check_every = 2
    state = dc.init_state()
    reader = FastaReader(io.BytesIO(text.encode()))
    with pytest.raises(RuntimeError, match="overflow"):
        for i, rows in enumerate(pipeline.batches_from_codes(
            pipeline.code_stream(reader), cfg
        )):
            state = dc.step(state, rows)
            assert i < 10, "overflow not raised fast"


@pytest.mark.parametrize("k", [12, 21])
def test_sparse_dist_repeated_compactions(rng, k):
    """Tiny per-device compaction threshold forces store-carrying
    row-wise compactions + squeezes on the mesh; spectrum stays exact
    (VERDICT item 2: LSM/log-store parity for dp_sparse)."""
    seq = random_dna(rng, 6000, n_prob=0.02)
    text = ">r\n" + seq + "\n"
    cfg = Config(
        k=k, chunk_len=64, batch_rows=8, table_mode="sparse",
        sparse_capacity=65536, sparse_compact_entries=2048,
    )
    spectrum = _count_dist(text, cfg, 8)
    assert spectrum_to_dict(spectrum, k) == oracle_dict(text, k)


@pytest.mark.parametrize("k", [12, 21, 31])
def test_sparse_dist_ordered_finalize_repeats(rng, k):
    """Coded-wire dp_sparse finalize (ROADMAP: ordered finalize for
    dp_sparse): repeat-heavy input forces many count exceptions per
    device row; k=12 covers the narrow wire, k=21 the run-coded hi
    wire, k=31 the per-entry hi wire."""
    seq = ("ACGTACGGTTCA" * 120) + random_dna(rng, 3000, n_prob=0.02)
    text = ">r\n" + seq + "\n"
    cfg = Config(
        k=k, chunk_len=64, batch_rows=8, table_mode="sparse",
        sparse_capacity=65536,
    )
    spectrum = _count_dist(text, cfg, 8)
    assert spectrum_to_dict(spectrum, k) == oracle_dict(text, k)


def test_sparse_dist_legacy_finalize_matches(rng, monkeypatch):
    """FINDKMER_ORDERED_FINALIZE=0 restores the full-plane heap-merge
    wire; both wires must produce identical spectra."""
    seq = ("ACGT" * 200) + random_dna(rng, 2000, n_prob=0.02)
    text = ">r\n" + seq + "\n"
    cfg = Config(k=21, chunk_len=64, batch_rows=8, sparse_capacity=65536)
    ordered = _count_dist(text, cfg, 8)
    monkeypatch.setenv("FINDKMER_ORDERED_FINALIZE", "0")
    legacy = _count_dist(text, cfg, 8)
    np.testing.assert_array_equal(ordered[0], legacy[0])
    np.testing.assert_array_equal(ordered[1], legacy[1])


def test_sparse_dist_capacity_error(rng):
    seq = random_dna(rng, 4000)
    text = ">r\n" + seq + "\n"
    cfg = Config(
        k=21, chunk_len=64, batch_rows=8, sparse_capacity=16,
        sparse_compact_entries=256,
    )
    with pytest.raises(RuntimeError, match="sparse_capacity"):
        _count_dist(text, cfg, 8)


@pytest.mark.parametrize("merge,k,width", [
    ("psum", 8, 4 ** 8), ("psum_scatter", 8, 4 ** 8),
    ("all_to_all", 11, 4 ** 11 // 4),
])
def test_dense_state_starts_sharded(merge, k, width):
    """The zero table is made as one slice per device, on that device."""
    cfg = Config(k=k, chunk_len=64, batch_rows=8, merge=merge,
                 table_mode="direct")
    dc = DistributedCounter(cfg, make_mesh(4))
    state = dc.init_state()
    table = state[0] if merge == "all_to_all" else state
    assert table.sharding == dc._state_sharding
    shards = table.addressable_shards
    assert sorted(s.device.id for s in shards) == [
        d.id for d in jax.devices()[:4]
    ]
    assert all(s.data.shape == (1, width) for s in shards)
    assert not np.asarray(table).any()
