"""Dense histogram paths must agree with numpy and each other — the
deterministic sort path is the de-facto race detector (SURVEY.md §5)."""

import numpy as np
import jax.numpy as jnp
import pytest

from findkmer_tpu.ops.histogram import (
    add_counts_onehot,
    add_counts_scatter,
    add_counts_sort,
    histogram,
)


def _case(rng, T, n, dup_heavy=False):
    hi = T // 8 if dup_heavy else T
    codes = rng.integers(0, max(1, hi), (4, n)).astype(np.int32)
    valid = rng.random((4, n)) < 0.8
    return jnp.asarray(codes), jnp.asarray(valid)


@pytest.mark.parametrize("T", [4, 256, 65536])
@pytest.mark.parametrize("dup_heavy", [False, True])
def test_paths_agree(rng, T, dup_heavy):
    codes, valid = _case(rng, T, 1000, dup_heavy)
    want = np.bincount(
        np.asarray(codes)[np.asarray(valid)], minlength=T
    ).astype(np.int32)

    for fn in (add_counts_scatter, add_counts_sort, add_counts_onehot):
        table = jnp.zeros((T,), jnp.int32)
        got = np.asarray(fn(codes, valid, table, T))
        np.testing.assert_array_equal(got, want, err_msg=fn.__name__)


def test_accumulates(rng):
    T = 64
    codes, valid = _case(rng, T, 500)
    t1 = add_counts_scatter(codes, valid, jnp.zeros((T,), jnp.int32), T)
    t2 = add_counts_scatter(codes, valid, t1, T)
    want = 2 * np.bincount(
        np.asarray(codes)[np.asarray(valid)], minlength=T
    )
    np.testing.assert_array_equal(np.asarray(t2), want)


def test_all_invalid(rng):
    T = 16
    codes = jnp.asarray(rng.integers(0, T, (2, 100)).astype(np.int32))
    valid = jnp.zeros((2, 100), bool)
    got = np.asarray(histogram(codes, valid, T))
    assert (got == 0).all()


@pytest.mark.parametrize("k", [1, 2, 4, 6, 8, 9, 10])
def test_onehot_outer_product_matches_bincount(rng, k):
    """The int8 outer-product histogram: exact counts with invalid
    windows, on a tile size that leaves a padded last tile."""
    T = 4 ** k
    codes = jnp.asarray(rng.integers(0, T, (3, 700)).astype(np.int32))
    valid = jnp.asarray(rng.random((3, 700)) < 0.7)
    want = np.bincount(
        np.asarray(codes)[np.asarray(valid)], minlength=T
    )
    got = add_counts_onehot(codes, valid, jnp.zeros((T,), jnp.int32), T,
                            chunk=512)
    np.testing.assert_array_equal(np.asarray(got), want)


@pytest.mark.parametrize("T", [4 ** 5, 3 * 4 ** 4, 2 ** 13])
def test_onehot_split_covers_table(T):
    """The radix split covers any table size (shard sizes too), with a
    power-of-two lo half."""
    from findkmer_tpu.ops.histogram import onehot_split

    t1, t2 = onehot_split(T)
    assert t2 & (t2 - 1) == 0
    assert (t1 - 1) * t2 < T <= t1 * t2


@pytest.mark.parametrize("k", range(1, 11))
def test_auto_resolves_to_an_xla_method(k):
    """auto follows the H100 dense-step sweep: onehot for k <= 4,
    scatter above (ops/histogram._AUTO_OVERRIDES)."""
    from findkmer_tpu.config import Config
    from findkmer_tpu.models.counter import KmerCounter

    want = "onehot" if k <= 4 else "scatter"
    assert KmerCounter(Config(k=k))._method == want


def test_config_rejects_unknown_hist():
    from findkmer_tpu.config import Config

    with pytest.raises(ValueError, match="unknown hist method 'pallas'"):
        Config(k=8, hist="pallas")


def test_cli_rejects_hist_pallas(fixtures_dir, capsys):
    import os

    from findkmer_tpu import cli

    with pytest.raises(SystemExit) as e:
        cli.main(["count", "-i", os.path.join(fixtures_dir, "tiny.fa"),
                  "-k", "4", "--hist", "pallas"])
    assert e.value.code == 2
    assert "invalid choice: 'pallas'" in capsys.readouterr().err
