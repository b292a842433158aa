"""Shared fixtures.  NOTE: no XLA_FLAGS here — unit tests run on 1 device;
multi-device tests spawn subprocesses (see tests/test_sharded.py)."""
import numpy as np
import pytest


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "cuda: needs a CUDA card (skips without one)")


@pytest.fixture(scope="session")
def rng():
    return np.random.default_rng(0)


def ftcs_oracle(T, w, steps):
    """NumPy FTCS reference used across solver tests."""
    T = T.copy()
    for _ in range(steps):
        new = T.copy()
        new[1:-1, 1:-1, 1:-1] = (
            (1 - 6 * w) * T[1:-1, 1:-1, 1:-1]
            + w * (T[2:, 1:-1, 1:-1] + T[:-2, 1:-1, 1:-1]
                   + T[1:-1, 2:, 1:-1] + T[1:-1, :-2, 1:-1]
                   + T[1:-1, 1:-1, 2:] + T[1:-1, 1:-1, :-2]))
        T = new
    return T


def heat_init(shape=(10, 12, 14)):
    T = np.full(shape, 500.0, np.float32)
    T[1:-1, 1:-1, 0] = 300.0
    T[1:-1, 1:-1, -1] = 400.0
    return T
