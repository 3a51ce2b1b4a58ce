"""Test configuration: an 8-device CPU JAX backend, or the GPU on request.

By default the tests run on the CPU: JAX_PLATFORMS=cpu and 8 virtual host
devices, so multi-device logic runs on one machine (the standard JAX trick,
SURVEY.md §4.2).  Both are set in pytest_configure, before any test module
imports jax.

`--on-device` leaves the backend as found and fails every test unless JAX
runs on a GPU: it is how `chip_smoke.py` runs the oracle subset on the card.
"""

import os
import sys

import numpy as np
import pytest

_REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, _REPO)


def pytest_addoption(parser):
    parser.addoption(
        "--on-device", action="store_true", default=False,
        help="run on the accelerator JAX finds (must be a GPU) instead of "
             "8 virtual CPU devices",
    )


def pytest_configure(config):
    if config.getoption("--on-device"):
        return
    os.environ["JAX_PLATFORMS"] = "cpu"
    flags = os.environ.get("XLA_FLAGS", "")
    if "xla_force_host_platform_device_count" not in flags:
        os.environ["XLA_FLAGS"] = (
            flags + " --xla_force_host_platform_device_count=8"
        ).strip()


@pytest.fixture(scope="session", autouse=True)
def _on_device_platform(request):
    """--on-device runs must really be on the GPU: no CPU fallback."""
    if request.config.getoption("--on-device"):
        import jax

        platform = jax.devices()[0].platform
        if platform != "gpu":
            pytest.fail(f"--on-device needs a GPU; JAX runs on {platform}")


def pytest_collection_modifyitems(config, items):
    """Two test tiers: `heavy` is set explicitly on slow tests
    (subprocess CLI, mesh-wide, GB-scale); everything else gets `quick`
    so both `-m quick` and `-m heavy` select a tier directly."""
    for item in items:
        if "heavy" not in item.keywords:
            item.add_marker(pytest.mark.quick)


@pytest.fixture(scope="session")
def rng():
    return np.random.default_rng(0)


def random_dna(rng, n, *, n_prob=0.0, lower_prob=0.0, iupac_prob=0.0):
    """Random test sequence with optional Ns / lowercase / IUPAC noise."""
    bases = np.array(list("ACGT"))
    seq = bases[rng.integers(0, 4, n)]
    if lower_prob:
        low = rng.random(n) < lower_prob
        seq = np.where(low, np.char.lower(seq), seq)
    if n_prob:
        seq = np.where(rng.random(n) < n_prob, "N", seq)
    if iupac_prob:
        iupac = np.array(list("RYSWKMBDHV"))
        hits = rng.random(n) < iupac_prob
        seq = np.where(hits, iupac[rng.integers(0, len(iupac), n)], seq)
    return "".join(seq)


@pytest.fixture(scope="session")
def fixtures_dir():
    return os.path.join(os.path.dirname(os.path.abspath(__file__)), "data")
