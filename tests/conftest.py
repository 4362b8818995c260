"""Shared fixtures.  NOTE: no XLA_FLAGS device forcing here — smoke tests
and benches must see the single real device (the dry-run sets its own)."""
import jax
import numpy as np
import pytest


def pytest_configure(config):
    config.addinivalue_line(
        "markers",
        "slow: compiles through jax/XLA; deselect with -m 'not slow' for a "
        "fast pure-python simulator signal (tier-1 runs everything)")
    config.addinivalue_line("markers", "cuda: needs an NVIDIA card; skips without one")


@pytest.fixture
def key():
    return jax.random.PRNGKey(0)


@pytest.fixture
def rng():
    return np.random.default_rng(0)


def assert_tree_allclose(a, b, rtol=1e-5, atol=1e-5):
    la, ta = jax.tree.flatten(a)
    lb, tb = jax.tree.flatten(b)
    assert ta == tb, (ta, tb)
    for x, y in zip(la, lb):
        np.testing.assert_allclose(np.asarray(x), np.asarray(y),
                                   rtol=rtol, atol=atol)
